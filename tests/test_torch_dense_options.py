"""The port's dense layer options equal the reference package's on the CPU:
qk-norm (qwen3), post-norms and 5:1-style local/global groups (gemma3), the
plain gelu MLP (starcoder2), the sliding-window variant of llama3.2-1b, and
the vision prefix (paligemma), each at its SMOKE size and as a windowed
variant.  Parameters are drawn by numpy with the reference's initialiser
scheme (:func:`draw`) and handed to both packages; inputs come from numpy
seeds; torch runs float32 on one thread.  Each reference function is
jitted once per configuration (module-scoped) and shared by the tests of
that configuration.

Every model quantity is held twice (the two regimes of
``tests/test_torch_train.py``): under the reference's initialiser, whose
stacked weights are drawn at std 0.25 and make the smoke models
ill-conditioned, within the spread measured on the reference itself (its
result moved by a one-ulp nudge of the weight matrices), and with the
weight matrices scaled by 0.1, tightly.  Errors and spreads are relative
to the quantity's largest magnitude; measured here, worst over the cases:

* Prefill and teacher-forced decode logits: 1e-3 under the reference's
  initialiser (port 8.5e-5; the reference's spread 8.6e-5) and 2e-5 tamed
  (4.3e-6; 3.9e-6).  Every KV-cache leaf after the prefill and after the
  last step: 2e-3 (port 2.0e-4; spread 9.2e-4) and 2e-5 tamed (3.9e-6;
  4.2e-6).
* ``loss_fn``: the loss at rtol 1e-6 (4.5e-7); every gradient leaf at 3e-2
  under the reference's initialiser (port 6.5e-3, gemma3's ``w_gate``; the
  reference's spread 2.1e-2) and 2e-5 tamed (3.6e-6; 5.0e-6).
* ``train_step``: as ``tests/test_torch_train.py`` holds it (the loss at
  rtol 1e-6, parameters at 1e-5 of scale + 2·lr, moments 3e-3 / 6e-3 of
  scale), with the weights scaled by 0.1.
* Windowed ``blockwise_attention`` and its dq/dk/dv: float32 at 1e-5,
  bfloat16 at 2^-7, as ``tests/test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_jit

from repro.configs import SMOKES as J_SMOKES
from repro.launch import mesh as j_mesh
from repro.launch import shapes as j_shapes
from repro.launch import steps as j_steps
from repro.models import common as jcommon
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JConfig
from repro.optim import adamw_init as j_adamw_init

from repro_torch.launch import steps as t_steps
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw_init, cosine_schedule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: each architecture's SMOKE and a windowed variant of it: local/global
#: groups (1, 1) or (3, 1) at window 16 (32 behind paligemma's 16 patches)
ARCHS = ("starcoder2-15b", "qwen3-14b", "gemma3-12b", "llama3.2-1b-sw", "paligemma-3b")
WINDOWED = {
    "starcoder2-15b": dict(local_global=(1, 1), window=16),
    "qwen3-14b": dict(local_global=(3, 1), window=16, n_layers=4),
    "gemma3-12b": dict(local_global=(3, 1), window=16, n_layers=4),
    "llama3.2-1b-sw": dict(local_global=(3, 1), window=16, n_layers=4),
    "paligemma-3b": dict(local_global=(1, 1), window=32),
}
#: (sequence, decode steps, attn_blk or None) per regime; the sequence
#: counts paligemma's 16 patch positions in front of its tokens
REGIMES = {
    # the SMOKE itself, one tile; gemma3's prompt is its window of 32, so
    # its local caches are padded past the window and the decode runs past
    # it (the window then starts after slot 0)
    "smoke": (32, 8, None),
    # prompt < window < max_len: the same padded local cache on the
    # windowed variant, decoding past the window
    "padded-ring": (8, 12, None),
    # prompt > window and not a multiple of it: a wrapped ring of window
    # slots (the tail rolled by 40 % window), prefilled through the local
    # path of blockwise_attention (attn_blk 8, S = 40 > 8 + window)
    "wrapped-ring-local-path": (40, 4, 8),
}
#: paligemma's sequences where its patches do not fit the above (window 32)
PALIGEMMA_SEQ = {"padded-ring": 24, "wrapped-ring-local-path": 56}
SCALES = {"reference-init": 1.0, "tamed": 0.1}
LOGIT_TOL = {"reference-init": 1e-3, "tamed": 2e-5}
CACHE_TOL = {"reference-init": 2e-3, "tamed": 2e-5}
GRAD_TOL = {"reference-init": 3e-2, "tamed": 2e-5}


def configs(arch, regime="smoke"):
    base = dataclasses.asdict(J_SMOKES[arch])
    if regime != "smoke":
        base.update(WINDOWED[arch])
    blk = REGIMES[regime][2]
    if blk is not None:
        base["attn_blk"] = blk
    return JConfig(**base), TConfig(**base)


def draw(cfg, seed):
    """Parameters of the reference's initialiser scheme (normal ×
    ``scale / sqrt(fan_in)`` with the fan-in of its ``materialize``, zeros
    for the norms) drawn by numpy, as the reference's tree of float32
    numpy arrays (the SMOKEs are float32)."""
    assert cfg.dtype == "float32"
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(jmodel.param_defs(cfg),
                                       is_leaf=lambda x: isinstance(x, jcommon.ParamDef))
    out = []
    for d in leaves:
        if d.init == "zeros":
            out.append(np.zeros(d.shape, np.float32))
            continue
        assert d.init == "normal"
        fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
        out.append(rng.standard_normal(d.shape).astype(np.float32)
                   * np.float32(d.scale / fan_in ** 0.5))
    return jax.tree.unflatten(treedef, out)


def scaled(tree, scale):
    """The tree with its weight matrices (not the norms) times ``scale``."""
    return jax.tree.map(lambda a: a * np.float32(scale) if a.ndim > 1 else a, tree)


class Reference:
    """One configuration's reference parameters, its loss gradient and its
    serving run (prefill, ``pad_cache``, then teacher-forced decode steps
    under one ``lax.scan``), each jitted and compiled once."""

    def __init__(self, arch, regime):
        self.jcfg, self.tcfg = configs(arch, regime)
        self.params = draw(self.jcfg, 0)
        self.grad = reference_jit.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, b, self.jcfg)))
        self.serve = reference_jit.jit(self._serve)

    def _serve(self, params, batch, forced):
        """(prefill logits, prefill cache, each step's logits, the cache
        after the last step)."""
        cfg = self.jcfg
        seq = REGIMES_SEQ(cfg, batch)
        logits, cache = jmodel.prefill(params, batch, cfg)
        padded = jmodel.pad_cache(cache, seq, seq + forced.shape[0])

        def step(c, xs):
            token, pos = xs
            out, c = jmodel.decode_step(params, c, token, pos, cfg)
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

    def get(arch, regime="smoke"):
        if (arch, regime) not in made:
            made[arch, regime] = Reference(arch, regime)
        return made[arch, regime]

    return get


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
    got, want = as_f32(got), as_f32(want).reshape(as_f32(got).shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + atol, f"{what}: max err {err:.3e} > {tol:g} x {scale:.3e} + {atol:g}"


def assert_caches_close(got, want, tol, what):
    """The port's ``{kind: {"k", "v"}}`` against the reference's
    ``{kind: {"attn": {"k", "v"}}}``: the same kinds, each leaf the
    reference's element order."""
    assert sorted(got) == sorted(want), what
    for kind in want:
        for name in ("k", "v"):
            g, w = got[kind][name], np.asarray(want[kind]["attn"][name])
            assert g.numel() == w.size and tuple(g.shape[1:]) == w.shape[2:], (what, kind)
            assert_scaled_close(g, w, tol, f"{what} {kind}/{name}")


def REGIMES_SEQ(cfg, batch):
    """The prefill's sequence length: the tokens, behind the patches."""
    seq = batch["tokens"].shape[1]
    return seq + (cfg.num_patches if cfg.frontend == "vision" else 0)


def inputs(cfg, b, plen, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, plen)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch, rng


CASES = [(arch, regime) for arch in ARCHS for regime in REGIMES]


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("arch,regime", CASES, ids=[f"{a}-{r}" for a, r in CASES])
def test_prefill_and_teacher_forced_decode_match(reference, arch, regime, scale):
    """Logits of the prefill and of every decode step, every cache leaf
    after the prefill and after the last step, through the regimes of the
    local layers' caches."""
    ref = reference(arch, regime)
    jcfg, tcfg = ref.jcfg, ref.tcfg
    jp, tp = ref.scaled(SCALES[scale])
    seq, steps, _ = REGIMES[regime]
    patches = jcfg.num_patches if jcfg.frontend == "vision" else 0
    if patches:
        seq = PALIGEMMA_SEQ.get(regime, seq)
    b = 2
    batch, rng = inputs(jcfg, b, seq - patches, 0)
    window = jcfg.window if jcfg.group_pattern[0] else None
    if regime == "padded-ring" or (regime == "smoke" and window):
        assert seq <= window < seq + steps
    elif regime != "smoke":
        assert seq > window and seq % window and seq > jcfg.attn_blk + window
    forced = rng.integers(0, jcfg.vocab, (steps, b)).astype(np.int32)

    jl, jc, jsteps, jlast = ref.serve(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                                      jnp.asarray(forced))
    tl, tc = tmodel.prefill(tp, {k: torch.as_tensor(v) for k, v in batch.items()}, tcfg)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (b, jcfg.padded_vocab)
    assert_scaled_close(tl, jl, LOGIT_TOL[scale], "prefill logits")
    assert_caches_close(tc, jc, CACHE_TOL[scale], "prefill")

    tc = tmodel.pad_cache(tc, seq, seq + steps)
    for step in range(steps):
        tl, tc = tmodel.decode_step(tp, tc, torch.as_tensor(forced[step]), seq + step, tcfg)
        assert_scaled_close(tl, jsteps[step], LOGIT_TOL[scale], f"step {step} logits")
    assert_caches_close(tc, jlast, CACHE_TOL[scale], "decode")


def lm_batch(cfg, b, s, seed):
    batch, rng = inputs(cfg, b, s, seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    batch["labels"] = labels
    return batch


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_every_gradient_leaf_match(reference, arch, scale):
    """The next-token loss (paligemma's patch positions padded with -1
    labels) and the gradient of every parameter leaf."""
    ref = reference(arch)
    jp, tp = ref.scaled(SCALES[scale])
    batch = lm_batch(ref.jcfg, 2, 64, 1)
    jl, jg = ref.grad(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = t_steps.loss_and_grads(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    ref.tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert sorted(tg) == sorted(k for k, _ in tp.named_parameters())
    got, want = flat(tmodel.params_to_tree(tg, ref.tcfg)), flat(jax.tree.map(np.asarray, jg))
    assert sorted(got) == sorted(want)
    for path in want:
        assert_scaled_close(got[path], want[path], GRAD_TOL[scale], "/".join(path))


@pytest.mark.parametrize("arch", ["gemma3-12b", "paligemma-3b"])
def test_train_step_matches_the_reference(arch):
    """One step of the reference's ``build_step`` train branch (on a 1 x 1
    host mesh) and of ``steps.train_step`` from the same parameters (the
    weight matrices scaled by 0.1)."""
    jcfg, tcfg = configs(arch)
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
    for what, got, want, tol, atol in (("params", tp, jp1, 1e-5, 2 * lr),
                                       ("m", to["m"], jo1["m"], 3e-3, 0.0),
                                       ("v", to["v"], jo1["v"], 6e-3, 0.0)):
        got, want = flat(tmodel.params_to_tree(got, tcfg)), flat(jax.tree.map(np.asarray, want))
        assert sorted(got) == sorted(want), what
        for path in want:
            assert_scaled_close(got[path], want[path], tol, f"{what} {'/'.join(path)}", atol)
    assert int(to["step"]) == int(jo1["step"]) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path,layout", [
    ("global", dict(b=2, s=64, h=4, kv=2, d=16, blk_q=16, blk_k=16, window=56)),
    ("local", dict(b=1, s=64, h=4, kv=1, d=16, blk_q=16, blk_k=16, window=20)),
], ids=["global", "local"])
def test_windowed_blockwise_attention_forward_and_vjp_match(path, layout, dtype):
    """Both paths of the windowed flash attention: the global one (S = 64
    <= blk_q + window: the window masked inside 16 x 16 tiles) and the
    local one (S = 64 > blk_q + window: one left-padded span per query
    tile)."""
    lay = dict(layout)
    b, s, h, kv, d = (lay.pop(k) for k in ("b", "s", "h", "kv", "d"))
    assert (s > lay["blk_q"] + lay["window"]) == (path == "local")
    rng = np.random.default_rng(13)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, kv, d)).astype(np.float32) for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    @reference_jit.jit
    def forward_and_vjp(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: jcommon.blockwise_attention(q, k, v, **lay), q, k, v)
        return o, vjp(do)

    jo, jgrads = forward_and_vjp(*(jnp.asarray(a, jdt) for a in (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    to = tcommon.blockwise_attention(tq, tk, tv, **lay)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert to.dtype == tdt
    assert_scaled_close(to, jo, tol, "o")
    for name, got, want in zip("qkv", tgrads, jgrads):
        assert got.dtype == tdt
        assert_scaled_close(got, want, tol, f"d{name}")


@pytest.mark.parametrize("arch,regime", [("gemma3-12b", "smoke"), ("qwen3-14b", "padded-ring"),
                                         ("paligemma-3b", "padded-ring")])
def test_params_round_trip_with_local_groups_and_vision_proj(arch, regime):
    """``params_from_numpy`` then ``params_to_tree`` gives the reference's
    tree back bit for bit: ``groups/local`` with its ``(n_groups, n_local)``
    axes, qk-norm and post-norm leaves, ``vision_proj``; the port's layers
    run in the reference's order (each group's local layers first)."""
    jcfg, tcfg = configs(arch, regime)
    tree = draw(jcfg, 5)
    params = tmodel.params_from_numpy(tree, tcfg, device="cpu")
    got, want = flat(tmodel.params_to_tree(params, tcfg)), flat(tree)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert np.array_equal(got[path].numpy(), w), path
    n_local, n_global = jcfg.group_pattern
    first_local = tree["groups"]["local"]["attn"]["wq"][0, 0]
    assert np.array_equal(params.layers[0].attn.wq.numpy(), first_local)
    last_global = tree["groups"]["global"]["attn"]["wq"][-1, -1]
    assert np.array_equal(params.layers[-1].attn.wq.numpy(), last_global)
    assert len(params.layers) == jcfg.n_groups * (n_local + n_global)


@pytest.mark.parametrize("seq_len", [8, 40])
def test_init_and_pad_cache_match_the_reference_with_local_layers(seq_len):
    """``init_cache``'s kinds and shapes (a local ring of min(window,
    seq_len) slots) and ``pad_cache``'s rule (every cache of prefill_len
    slots grows, the others pass through) on the same values."""
    jcfg, tcfg = configs("qwen3-14b", "padded-ring")
    got = tmodel.init_cache(tcfg, 3, seq_len, device="cpu")
    want = jmodel.init_cache(jcfg, 3, seq_len)
    assert sorted(got) == sorted(want)
    rng = np.random.default_rng(seq_len)
    tcache, jcache = {}, {}
    for kind in want:
        assert not got[kind]["k"].any()
        tcache[kind], jcache[kind] = {}, {"attn": {}}
        for name in ("k", "v"):
            w = np.asarray(want[kind]["attn"][name])
            assert tuple(got[kind][name].shape) == (w.shape[0] * w.shape[1],) + w.shape[2:]
            x = rng.standard_normal(w.shape).astype(np.float32)
            tcache[kind][name] = torch.from_numpy(x.reshape(got[kind][name].shape))
            jcache[kind]["attn"][name] = jnp.asarray(x)
    grown = tmodel.pad_cache(tcache, seq_len, seq_len + 8)
    assert_caches_close(grown, jmodel.pad_cache(jcache, seq_len, seq_len + 8), 0.0, "pad")
    assert (grown["local"]["k"].shape[2] == seq_len + 8) == (seq_len <= jcfg.window)
