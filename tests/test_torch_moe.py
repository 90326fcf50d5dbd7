"""The port's mixture-of-experts family equals the reference package's on the CPU.

``repro_torch.models.moe`` against ``repro.models.moe`` (the router, top-k,
capacity dispatch and expert products), then ``granite-moe-3b-a800m`` and
``grok-1-314b`` at their SMOKE sizes through prefill, decode, the loss and
its gradients, ``train_step``, checkpoints and the serving engine.  Inputs
come from numpy seeds; parameters are drawn by numpy with the reference's
initialiser scheme (:func:`draw`) and handed to both packages; torch runs
on one thread.  Each reference program is jitted once per shape and shared.

Two reference facts are pinned exactly, not within a tolerance:

* **The slot search.** ``jnp.searchsorted`` (a fixed-depth bisection) over
  a ``slot`` row that is not sorted (dropped entries hold ``E·cap``
  between the experts' kept runs) is equalled index for index by
  ``moe.scan_searchsorted``; ``torch.searchsorted`` gives other indices on
  some of the same rows.
* **top-k ties.** ``moe.top_k`` equals ``jax.lax.top_k``, values and
  indices, on uniform and partly tied rows.

``moe_layer`` is held with an integer-valued router and integer inputs:
the router logits are then exact integers in both packages, so both
choose the same experts, in the same order, and drop the same entries;
the outputs are held at 1e-5 of their largest magnitude in float32
(measured ≤ 6.0e-7) and 2^-6 in bfloat16 (measured ≤ 6.5e-3: the expert
products round each hidden element to bfloat16 in another order, one
bfloat16 ulp of 2^-8 of an element, summed over the chosen experts).
``moe_layer_ref`` against the reference's, and ``moe_layer`` against it
where no expert overflows: 1e-5 (measured ≤ 7.7e-7, and 0).

The models are held in the two regimes of ``tests/test_torch_train.py``
with the tolerances of ``tests/test_torch_dense_options.py``, against what
was measured on the CPU (port; the reference's own spread under a one-ulp nudge
of its weight matrices), worst of granite and grok:

* Prefill and teacher-forced decode logits: 1e-3 under the reference's
  initialiser (port 1.1e-4; spread 1.1e-4) and 2e-5 with the weight
  matrices scaled by 0.1 (2.4e-6; 1.8e-6).  Every KV-cache leaf after the
  prefill and after the last step: 2e-3 (8.4e-5; 5.6e-5) and 2e-5 (1.3e-6;
  1.5e-6).
* ``loss_fn``: the loss at rtol 1e-6 (5.2e-7); every gradient leaf, the
  router and the experts included, at 3e-2 (2.7e-3; spread 9.8e-3) and
  2e-5 tamed (2.6e-6; 4.5e-6).
* ``train_step``, weights scaled by 0.1: the loss at rtol 1e-6; the new
  parameters at 1e-5 of scale + 2·lr; float32 moments at 3e-3 (``m``) and
  6e-3 (``v``) of scale, as ``tests/test_torch_train.py``; bfloat16
  moments at 2^-7 of scale, one bfloat16 ulp (a float32 value one ulp
  apart may round to the neighbouring bfloat16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_jit

from repro import checkpoint as jckpt
from repro.configs import ARCHS as J_ARCHS
from repro.configs import SMOKES as J_SMOKES
from repro.launch import mesh as j_mesh
from repro.launch import shapes as j_shapes
from repro.launch import steps as j_steps
from repro.models import common as jcommon
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro.optim import adamw_init as j_adamw_init
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine

from repro_torch import checkpoint as tckpt
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.launch import steps as t_steps
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.transformer import Params
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MOE_ARCHS = ("granite-moe-3b-a800m", "grok-1-314b")
SCALES = {"reference-init": 1.0, "tamed": 0.1}
LOGIT_TOL = {"reference-init": 1e-3, "tamed": 2e-5}
CACHE_TOL = {"reference-init": 2e-3, "tamed": 2e-5}
GRAD_TOL = {"reference-init": 3e-2, "tamed": 2e-5}


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, dtype=np.float32)


def assert_scaled_close(got, want, tol, what="", atol=0.0):
    """max |got - want| <= tol · max |want| + atol."""
    got = as_f32(got)
    want = as_f32(want).reshape(got.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + atol, f"{what}: max err {err:.3e} > {tol:g} x {scale:.3e} + {atol:g}"


def assert_trees_close(got_tree, want_tree, tol, what="", atol=0.0):
    got, want = flat(got_tree), flat(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want), what
    for path in want:
        assert_scaled_close(got[path], want[path], tol, f"{what} {'/'.join(path)}", atol)


def configs(arch, **change):
    base = dataclasses.asdict(J_SMOKES[arch])
    base.update(change)
    return JConfig(**base), TConfig(**base)


def draw(cfg, seed):
    """Parameters of the reference's initialiser scheme (normal ×
    ``scale / sqrt(fan_in)`` with the fan-in of its ``materialize``, zeros
    for the norms) drawn by numpy, as the reference's tree of float32
    numpy arrays (the SMOKEs are float32; the router is float32 always)."""
    assert cfg.dtype == "float32"
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(jmodel.param_defs(cfg),
                                       is_leaf=lambda x: isinstance(x, jcommon.ParamDef))
    out = []
    for d in leaves:
        if d.init == "zeros":
            out.append(np.zeros(d.shape, np.float32))
            continue
        fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
        out.append(rng.standard_normal(d.shape).astype(np.float32)
                   * np.float32(d.scale / fan_in ** 0.5))
    return jax.tree.unflatten(treedef, out)


def scaled(tree, scale):
    """The tree with its weight matrices (not the norms) times ``scale``."""
    return jax.tree.map(lambda a: a * np.float32(scale) if a.ndim > 1 else a, tree)


# ---------------------------------------------------------------------------
# the configurations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_configs_and_counts_are_the_references(arch):
    for got, want in ((ARCHS[arch], J_ARCHS[arch]), (SMOKES[arch], J_SMOKES[arch])):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
    assert (ARCHS["grok-1-314b"].opt_dtype, ARCHS["grok-1-314b"].grad_accum) == ("bfloat16", 8)
    # the dense count is the whole count
    assert ARCHS["llama3.2-1b"].active_param_count() == ARCHS["llama3.2-1b"].param_count()


# ---------------------------------------------------------------------------
# the two reference facts: the slot search and the top-k tie order
# ---------------------------------------------------------------------------


def slot_rows(rng, rows, s, k, e, factor=1.25):
    """``slot`` rows built as the reference's ``moe_layer`` builds them
    (``src/repro/models/moe.py:86-109``) from random top-k choices:
    kept entries ``expert·cap + position``, dropped ones ``E·cap``."""
    keys = rng.random((rows, s, e))
    # skew: in every other row most tokens choose expert 0 first
    skew = rng.random((rows, s)) < 0.6
    skew[::2] = False
    keys[skew, 0] = -1.0
    idx = np.argsort(keys, axis=-1)[..., :k]
    eid = idx.reshape(rows, s * k)
    order = np.argsort(eid, axis=-1, kind="stable")
    eid_s = np.take_along_axis(eid, order, axis=-1)
    counts = np.stack([(eid == j).sum(-1) for j in range(e)], -1)
    start = np.cumsum(counts, -1) - counts
    pos = np.arange(s * k)[None] - np.take_along_axis(start, eid_s, -1)
    cap = int(s * k / e * factor)
    cap = max(k, -(-cap // 4) * 4)
    return np.where(pos < cap, eid_s * cap + pos, e * cap), cap


#: (S, k, E) of the slot rows; on the first three torch.searchsorted's
#: bisection (another midpoint rule) ends elsewhere than jnp's on some rows
SEARCH_SHAPES = [(17, 2, 4), (33, 3, 5), (24, 2, 8), (40, 4, 8), (64, 2, 4), (9, 1, 8),
                 (128, 8, 40)]


@pytest.mark.parametrize("s,k,e", SEARCH_SHAPES)
def test_scan_searchsorted_is_jnp_searchsorted_on_unsorted_rows(s, k, e):
    """64 rows a shape, half of them skewed toward expert 0."""
    rng = np.random.default_rng(s * 100 + k * 10 + e)
    slot, cap = slot_rows(rng, 64, s, k, e)
    queries = np.broadcast_to(np.arange(e * cap), (slot.shape[0], e * cap))
    want = np.asarray(jax.vmap(jnp.searchsorted)(jnp.asarray(slot), jnp.asarray(queries)))
    got = tmoe.scan_searchsorted(torch.from_numpy(slot), torch.from_numpy(queries.copy()))
    assert np.array_equal(got.numpy(), want)
    # the rows are not sorted, so the bisection misses kept slots, and
    # torch's own search misses others
    kept = slot < e * cap
    hit = np.take_along_axis(slot, np.minimum(want, s * k - 1), -1) == queries
    assert (kept.sum(-1) > hit.sum(-1)).any()
    theirs = torch.searchsorted(torch.from_numpy(slot), torch.from_numpy(queries.copy())).numpy()
    if SEARCH_SHAPES.index((s, k, e)) < 3:
        assert (theirs != want).any()


def test_scan_searchsorted_on_sorted_rows_is_the_insertion_point():
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 50, (16, 37)), axis=-1)
    q = rng.integers(-2, 53, (16, 20))
    got = tmoe.scan_searchsorted(torch.from_numpy(a), torch.from_numpy(q)).numpy()
    want = np.stack([np.searchsorted(a[i], q[i], side="left") for i in range(16)])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["uniform", "partly-tied", "random"])
def test_top_k_is_lax_top_k(case):
    rng = np.random.default_rng(5)
    if case == "uniform":
        x = np.full((6, 40), 1 / 40, np.float32)
    elif case == "partly-tied":
        x = rng.integers(0, 4, (64, 40)).astype(np.float32) / 4
    else:
        x = rng.standard_normal((64, 40)).astype(np.float32)
    for k in (1, 2, 8):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tmoe.top_k(torch.from_numpy(x), k)
        assert np.array_equal(gi.numpy(), np.asarray(wi)) and np.array_equal(gv.numpy(), np.asarray(wv))
    if case == "uniform":
        assert np.array_equal(gi.numpy(), np.broadcast_to(np.arange(8), (6, 8)))


# ---------------------------------------------------------------------------
# moe_layer against the reference's, with exact routing
# ---------------------------------------------------------------------------


def layer_inputs(cfg, b, s, regime, seed):
    """An integer-valued router (D, E) and integer inputs (B, S, D), and
    expert weights of the reference's scale, as numpy float32.

    ``overflow``: every token's router logit of expert 0 is raised by 500, so
    each row sends all its tokens to it (S entries for cap < S).
    ``balanced``: the first E input features carry the logits exactly
    (router rows 0..E-1 the identity, the rest 0): token t gives experts
    t mod E and t + 1 mod E the tied logit 5, so every expert gets
    2S/E entries, within its capacity.  ``random``: small integers."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    x = rng.integers(-2, 3, (b, s, d)).astype(np.float32)
    router = rng.integers(-1, 2, (d, e)).astype(np.float32)
    if regime == "overflow":
        x[..., 0] = 100.0
        router[0] = 0.0
        router[0, 0] = 5.0
    elif regime == "balanced":
        router[:] = 0.0
        router[np.arange(e), np.arange(e)] = 1.0
        x[..., :e] = 0.0
        t = np.arange(s)
        x[:, t, t % e] = 5.0
        x[:, t, (t + 1) % e] = 5.0
    weights = {"router": router,
               "w_up": rng.standard_normal((e, d, f)).astype(np.float32) / d ** 0.5,
               "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) / d ** 0.5,
               "w_down": rng.standard_normal((e, f, d)).astype(np.float32) / f ** 0.5}
    return x, weights


@pytest.fixture(scope="module")
def jitted():
    """The reference's ``moe_layer``/``moe_layer_ref``, one jitted program
    per configuration (shapes and dtypes retrace inside it)."""
    made = {}

    def get(fn, arch):
        if (fn, arch) not in made:
            cfg = J_SMOKES[arch]
            made[fn, arch] = reference_jit.jit(lambda p, x: getattr(jmoe, fn)(p, x, cfg))
        return made[fn, arch]

    return get


def both(weights, x, dtype):
    """The same weights and input for both packages: expert weights and x
    in ``dtype``, the router in float32."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt) for k, v in weights.items()}
    tp = Params({k: torch.from_numpy(v).to(torch.float32 if k == "router" else tdt)
                 for k, v in weights.items()})
    return jp, tp, jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


LAYER_CASES = [("overflow", 2, 64), ("balanced", 2, 64), ("random", 3, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regime,b,s", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_matches_the_reference(jitted, arch, regime, b, s, dtype):
    """s > 1 with expert 0 overflowing (its entries past the capacity
    drop, and the bisection misses kept slots), s > 1 with no overflow,
    and s = 1 (decode's capacity)."""
    cfg = SMOKES[arch]
    x, weights = layer_inputs(cfg, b, s, regime, seed=len(regime) + s)
    jp, tp, jx, tx = both(weights, x, dtype)
    want = jitted("moe_layer", arch)(jp, jx)
    got = tmoe.moe_layer(tp, tx, cfg)
    assert got.dtype == tx.dtype and tuple(got.shape) == (b, s, cfg.d_model)
    assert_scaled_close(got, want, 1e-5 if dtype == "float32" else 2.0 ** -6, "moe_layer")

    r = tmoe.dispatch(tp.router, tx, cfg)
    assert r.cap == tmoe.capacity(cfg, s) == (40 if s == 64 else 1)
    over = int((~r.keep).sum())
    missed = int(r.keep.sum() - r.slot_hit.sum())
    if regime == "overflow":
        # each row: S entries of expert 0 alone for a capacity of 40
        assert over >= b * (s - r.cap) and missed > 0
    else:
        assert over == 0 and missed == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_ref_matches_the_reference_and_moe_layer_without_overflow(jitted, arch):
    cfg = SMOKES[arch]
    for regime, b, s in LAYER_CASES:
        x, weights = layer_inputs(cfg, b, s, regime, seed=7)
        jp, tp, jx, tx = both(weights, x, "float32")
        ref = tmoe.moe_layer_ref(tp, tx, cfg)
        assert_scaled_close(ref, jitted("moe_layer_ref", arch)(jp, jx), 1e-5, f"ref {regime}")
        if regime != "overflow":
            assert_scaled_close(tmoe.moe_layer(tp, tx, cfg), ref, 1e-5, f"layer {regime}")


# ---------------------------------------------------------------------------
# the SMOKE models: serving, the loss, train_step, checkpoints
# ---------------------------------------------------------------------------


class Reference:
    """One SMOKE's reference parameters, its loss gradient and its serving
    run (prefill, ``pad_cache``, teacher-forced decode steps under one
    ``lax.scan``), each jitted and compiled once."""

    def __init__(self, arch):
        self.jcfg, self.tcfg = configs(arch)
        self.params = draw(self.jcfg, 0)
        self.grad = reference_jit.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, b, self.jcfg)))
        self.serve = reference_jit.jit(self._serve)

    def _serve(self, params, tokens, forced):
        cfg, seq = self.jcfg, tokens.shape[1]
        logits, cache = jmodel.prefill(params, {"tokens": tokens}, cfg)
        padded = jmodel.pad_cache(cache, seq, seq + forced.shape[0])

        def step(c, xs):
            out, c = jmodel.decode_step(params, c, xs[0], xs[1], cfg)
            return c, out

        positions = seq + jnp.arange(forced.shape[0], dtype=jnp.int32)
        last, step_logits = jax.lax.scan(step, padded, (forced, positions))
        return logits, cache, step_logits, last

    def scaled(self, scale):
        jp = scaled(self.params, scale)
        return jp, tmodel.params_from_numpy(jp, self.tcfg, device="cpu")


@pytest.fixture(scope="module")
def reference():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = Reference(arch)
        return made[arch]

    return get


def assert_caches_close(got, want, tol, what):
    assert sorted(got) == ["global"] == sorted(want), what
    for name in ("k", "v"):
        g, w = got["global"][name], np.asarray(want["global"]["attn"][name])
        assert g.numel() == w.size and tuple(g.shape[1:]) == w.shape[2:], what
        assert_scaled_close(g, w, tol, f"{what} {name}")


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_teacher_forced_decode_match(reference, arch, scale):
    """Prefill (S = 32: cap 20 a row) and 8 decode steps (cap 1)."""
    ref = reference(arch)
    jp, tp = ref.scaled(SCALES[scale])
    b, seq, steps = 2, 32, 8
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, ref.jcfg.vocab, (b, seq)).astype(np.int32)
    forced = rng.integers(0, ref.jcfg.vocab, (steps, b)).astype(np.int32)
    jl, jc, jsteps, jlast = ref.serve(jp, jnp.asarray(tokens), jnp.asarray(forced))
    tl, tc = tmodel.prefill(tp, {"tokens": torch.as_tensor(tokens)}, ref.tcfg)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (b, ref.jcfg.padded_vocab)
    assert_scaled_close(tl, jl, LOGIT_TOL[scale], "prefill logits")
    assert_caches_close(tc, jc, CACHE_TOL[scale], "prefill")
    tc = tmodel.pad_cache(tc, seq, seq + steps)
    for step in range(steps):
        tl, tc = tmodel.decode_step(tp, tc, torch.as_tensor(forced[step]), seq + step, ref.tcfg)
        assert_scaled_close(tl, jsteps[step], LOGIT_TOL[scale], f"step {step} logits")
    assert_caches_close(tc, jlast, CACHE_TOL[scale], "decode")


def lm_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_fn_value_and_every_gradient_leaf_match(reference, arch, scale):
    """The loss and the gradient of every leaf: the float32 router, the
    stacked experts ``(n_groups, n_global, E, d, f)``, attention, norms and
    the embedding."""
    ref = reference(arch)
    jp, tp = ref.scaled(SCALES[scale])
    batch = lm_batch(ref.jcfg, 2, 64, 1)
    jl, jg = ref.grad(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = t_steps.loss_and_grads(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    ref.tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert sorted(tg) == sorted(k for k, _ in tp.named_parameters())
    assert tg["layers.0.mlp.router"].dtype == torch.float32
    assert tuple(tg["layers.1.mlp.w_down"].shape) == (ref.jcfg.n_experts, ref.jcfg.d_ff,
                                                       ref.jcfg.d_model)
    assert_trees_close(tmodel.params_to_tree(tg, ref.tcfg), jg, GRAD_TOL[scale], "grad")


@pytest.mark.parametrize("arch,change", [("grok-1-314b", dict(opt_dtype="bfloat16")),
                                         ("granite-moe-3b-a800m", dict(grad_accum=2))],
                         ids=["grok-bf16-moments", "granite-grad-accum-2"])
def test_train_step_matches_the_reference(arch, change):
    """One step of the reference's ``build_step`` train branch (on a 1 x 1
    host mesh) and of ``steps.train_step`` from the same parameters (the
    weight matrices scaled by 0.1): grok's bfloat16 AdamW moments, and
    granite over two micro-batches."""
    jcfg, tcfg = configs(arch, **change)
    jp = scaled(draw(jcfg, 2), 0.1)
    jo = j_adamw_init(jp, jcfg.opt_dtype)
    fn = j_steps.build_step(jcfg, j_shapes.SHAPES["train_4k"], multi_pod=False)[0]
    batch = lm_batch(jcfg, 4, 32, 4)
    with jax.set_mesh(j_mesh.make_host_mesh()):
        jp1, jo1, jm1 = reference_jit.jit(fn)(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tmodel.params_from_numpy(jp, tcfg, device="cpu")
    to = adamw_init(tp, tcfg.opt_dtype)
    lr = float(cosine_schedule(to["step"], peak_lr=3e-4, warmup=2000, total=100_000))
    tp, to, metrics = t_steps.train_step(tp, to, {k: torch.from_numpy(v) for k, v in batch.items()},
                                         tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm1["loss"]), rtol=1e-6)
    assert_trees_close(tmodel.params_to_tree(tp, tcfg), jp1, 1e-5, "params", 2 * lr)
    bf16 = tcfg.opt_dtype == "bfloat16"
    for mom, tol in (("m", 3e-3), ("v", 6e-3)):
        leaves = to[mom].values()
        assert all(t.dtype == (torch.bfloat16 if bf16 else torch.float32) for t in leaves)
        assert_trees_close(tmodel.params_to_tree(to[mom], tcfg), jo1[mom],
                           2.0 ** -7 if bf16 else tol, mom)
    assert int(to["step"]) == int(jo1["step"]) == 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_round_trip_and_checkpoints_cross(arch, tmp_path):
    """``params_from_numpy`` then ``params_to_tree`` gives the reference's
    tree back bit for bit (the float32 router, the stacked experts), as
    ``opt_state_from_numpy`` does the reference's AdamW moments; a
    checkpoint the reference writes loads into the port, and one the port
    writes loads into the reference."""
    jcfg, tcfg = configs(arch)
    tree = draw(jcfg, 5)
    params = tmodel.params_from_numpy(tree, tcfg, device="cpu")
    got, want = flat(tmodel.params_to_tree(params, tcfg)), flat(tree)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert np.array_equal(got[path].numpy(), w), path
    assert params.layers[0].mlp.router.dtype == torch.float32
    assert np.array_equal(params.layers[1].mlp.w_up.numpy(),
                          tree["groups"]["global"]["mlp"]["w_up"][1, 0])
    # the reference's AdamW state over the same leaves carries over too
    state = {"m": tree, "v": scaled(tree, 2.0), "step": np.int32(3)}
    opt = tmodel.opt_state_from_numpy(state, tcfg, device="cpu")
    assert int(opt["step"]) == 3
    for mom in ("m", "v"):
        assert_trees_close(tmodel.params_to_tree(opt[mom], tcfg), state[mom], 0.0, mom)

    jckpt.save_checkpoint(tmp_path / "ref.npz", jax.tree.map(jnp.asarray, tree), step=7)
    template = tmodel.params_to_tree(tmodel.init_params(tcfg, torch.Generator().manual_seed(1),
                                                        device="cpu"), tcfg)
    loaded, step = tckpt.load_checkpoint(tmp_path / "ref.npz", template)
    assert step == 7
    back = tmodel.params_to_tree(tmodel.params_from_numpy(loaded, tcfg, device="cpu"), tcfg)
    assert_trees_close(back, tree, 0.0, "reference -> port")

    tckpt.save_checkpoint(tmp_path / "port.npz", tmodel.params_to_tree(params, tcfg), step=3)
    restored, step = jckpt.load_checkpoint(tmp_path / "port.npz", jmodel.abstract_params(jcfg))
    assert step == 3
    assert_trees_close(restored, tree, 0.0, "port -> reference")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_draws_the_moe_leaves(arch):
    """The port's own draw (the full-width shapes are held in
    ``tests/test_torch_model.py``): the router float32, every expert drawn,
    the same generator seed the same weights."""
    cfg = SMOKES[arch]
    a, again = (tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
                for _ in range(2))
    mlp = a.layers[0].mlp
    assert mlp.router.dtype == torch.float32 and mlp.w_up.dtype == cfg.torch_dtype
    assert tuple(mlp.w_gate.shape) == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert all(bool(w[i].any()) for w in (mlp.w_up, mlp.w_gate, mlp.w_down)
               for i in range(cfg.n_experts))
    for (name, x), (_, y) in zip(a.named_parameters(), again.named_parameters()):
        assert torch.equal(x, y), name


def test_granite_serving_engine_matches_the_reference():
    """granite's SMOKE through both serving engines on the same requests
    and parameters (the reference's initialiser): every request's tokens,
    admission and stats equal, the slices all released."""
    arch = "granite-moe-3b-a800m"
    jcfg, tcfg = configs(arch)
    jp = draw(jcfg, 0)
    tp = tmodel.params_from_numpy(jp, tcfg, device="cpu")
    specs = [(5, "1g.10gb"), (3, "2g.20gb"), (6, "3g.40gb"), (0, "1g.20gb"), (4, "1g.10gb"),
             (2, "4g.40gb")]
    out = []
    for cls, engine_cls, cfg, p, extra in (
            (JRequest, JEngine, jcfg, jax.tree.map(jnp.asarray, jp), {}),
            (TRequest, TEngine, tcfg, tp, {"device": "cpu"})):
        rng = np.random.default_rng(3)
        reqs = [cls(i, rng.integers(0, cfg.vocab, 12).astype(np.int32), n, prof)
                for i, (n, prof) in enumerate(specs)]
        engine = engine_cls(cfg, p, num_slots=3, max_len=24, num_gpus=2, **extra)
        stats = engine.run(reqs)
        out.append((stats, [(r.request_id, r.output, r.admitted, r.rejected, r.finished)
                            for r in reqs], engine))
    (jstats, jreqs, jengine), (tstats, treqs, tengine) = out
    assert treqs == jreqs and tstats == jstats
    assert np.array_equal(tengine.admission.cluster.occupancy_matrix(),
                          jengine.admission.cluster.occupancy_matrix())
    assert tengine.admission.cluster.used_mem_slices == 0
    assert [len(r[1]) for r in treqs] == [n for n, _ in specs]
