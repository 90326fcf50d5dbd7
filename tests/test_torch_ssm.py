"""The port's Mamba-2 (SSD) block and its ssm and hybrid families equal the
reference package's on the CPU.

``repro_torch.models.ssm`` against ``repro.models.ssm`` (the chunked SSD,
its decode cache and the O(1) decode step), then ``mamba2-2.7b`` and
``hymba-1.5b`` at their SMOKE sizes through prefill, decode across the
hybrid's local ring, the loss and every gradient leaf, ``train_step``,
checkpoints and the serving engine, and the reference's ``pad_cache``
trap.  Inputs come from numpy seeds; parameters are drawn by numpy with
the reference's initialiser scheme (:func:`draw`) and handed to both
packages; torch runs on one thread.  Each reference program is jitted once
per shape through ``tests/reference_jit.py`` and shared.

Tolerances, relative to the quantity's largest magnitude, against what was
measured on the CPU (``python tests/test_torch_ssm.py`` prints the port's
errors and the reference's own spread: its result moved by a one-ulp nudge
of every weight matrix), worst over the cases:

* The SSD block at mamba2's SMOKE widths (random ``a_log``, ``dt_bias``,
  ``d_skip`` and gated norm; L = 4 chunks, and L = 2, under one chunk and
  under W - 1):
  ``ssm_forward``, its state and conv tail, and one ``ssm_decode_step``
  and its new state at 1e-5 in float32 (port 1.1e-6; spread 1.1e-6) and
  2^-6 in bfloat16 (port 7.0e-3; spread 2.6e-2: the two libraries round
  the bfloat16 chain of projections, conv output, silu and gated norm at
  other points; one bfloat16 ulp is 2^-8).
* Prefill and teacher-forced decode logits: 1e-3 under the reference's
  initialiser (port 2.3e-5; spread 9.8e-6) and 2e-5 with the weight
  matrices scaled by 0.1 (1.8e-6; 1.8e-6).  Every cache leaf (keys,
  values, SSD states, conv histories) after the prefill and after the
  last step: 2e-3 (2.1e-5; 2.3e-5) and 2e-5 (2.2e-6; 1.6e-6).
* Both SMOKEs in bfloat16 (weights scaled by 0.1): logits and cache
  leaves at 2^-4 (port 1.8e-2 and 2.9e-2; spread 5.8e-2 and 9.7e-2).
* ``loss_fn``: the loss at rtol 1e-6; every gradient leaf at 3e-2 under
  the reference's initialiser (port 5.0e-3; spread 1.7e-3) and 1e-4 tamed
  (port 1.5e-5; spread 1.1e-5; the worst leaf is hymba's ``a_log``, whose
  gradient sums terms of both signs over every position of a head).
* ``train_step``, weights scaled by 0.1: the loss at rtol 1e-6; the new
  parameters at 1e-5 of scale + 2·lr; float32 moments at 3e-3 (``m``) and
  6e-3 (``v``) of scale, as ``tests/test_torch_train.py``.

The reference's ``pad_cache`` grows every cache leaf whose axis -3 equals
the prompt length, the SSD leaves too: axis -3 of ``state`` (…, B, H, N,
P) is the head count H, of ``conv`` (…, B, W - 1, C) the batch B.  A
prompt of H or B tokens therefore breaks the reference's first decode
step; the port raises there too, and decodes equal to the reference
otherwise (:func:`test_pad_cache_trap_fails_exactly_where_the_reference_fails`).
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
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JConfig
from repro.optim import adamw_init as j_adamw_init
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine

from repro_torch import checkpoint as tckpt
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.launch import steps as t_steps
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
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


SSM_ARCHS = ("mamba2-2.7b", "hymba-1.5b")
SCALES = {"reference-init": 1.0, "tamed": 0.1}
LOGIT_TOL = {"reference-init": 1e-3, "tamed": 2e-5}
CACHE_TOL = {"reference-init": 2e-3, "tamed": 2e-5}
GRAD_TOL = {"reference-init": 3e-2, "tamed": 1e-4}
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
BF16_MODEL_TOL = 2.0 ** -4


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


def scaled_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got = as_f32(got)
    want = as_f32(want).reshape(got.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


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


def _defs(defs):
    return jax.tree.flatten(defs, is_leaf=lambda x: isinstance(x, jcommon.ParamDef))


def draw(cfg, seed, defs=None):
    """Parameters of the reference's initialiser scheme (normal ×
    ``scale / sqrt(fan_in)`` with the fan-in of its ``materialize``, zeros
    and ones where it puts them) drawn by numpy in float32, then cast to
    each leaf's dtype (``ml_dtypes.bfloat16`` for bfloat16 leaves): the
    reference's tree of numpy arrays."""
    rng = np.random.default_rng(seed)
    leaves, treedef = _defs(jmodel.param_defs(cfg) if defs is None else defs)
    out = []
    for d in leaves:
        if d.init in ("zeros", "ones"):
            a = np.full(d.shape, 0.0 if d.init == "zeros" else 1.0, np.float32)
        else:
            fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
            a = rng.standard_normal(d.shape).astype(np.float32) * np.float32(d.scale / fan_in ** 0.5)
        out.append(np.asarray(jnp.asarray(a, d.dtype or cfg.dtype)))
    return jax.tree.unflatten(treedef, out)


def scaled(tree, cfg, scale):
    """The tree with its drawn weights (the ``normal`` leaves; not the
    norms, ``a_log``, ``d_skip`` or the biases) times ``scale``."""
    leaves, treedef = _defs(jmodel.param_defs(cfg))
    values = jax.tree.leaves(tree)
    return jax.tree.unflatten(treedef, [
        np.asarray(jnp.asarray(a.astype(np.float32) * np.float32(scale), a.dtype))
        if d.init == "normal" else a for d, a in zip(leaves, values)])


def nudged(tree, cfg):
    """The tree with every drawn weight moved by one ulp (toward +inf):
    the reference's own spread is its result on this tree."""
    leaves, treedef = _defs(jmodel.param_defs(cfg))
    values = jax.tree.leaves(tree)
    return jax.tree.unflatten(treedef, [
        np.asarray(jnp.nextafter(jnp.asarray(a), jnp.asarray(np.inf, a.dtype)))
        if d.init == "normal" else a for d, a in zip(leaves, values)])


# ---------------------------------------------------------------------------
# the configurations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_configs_and_counts_are_the_references(arch):
    for got, want in ((ARCHS[arch], J_ARCHS[arch]), (SMOKES[arch], J_SMOKES[arch])):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert (got.ssm_dinner, got.ssm_nheads) == (want.ssm_dinner, want.ssm_nheads)
    assert (ARCHS["mamba2-2.7b"].ssm_nheads, ARCHS["hymba-1.5b"].ssm_nheads) == (80, 50)
    assert ARCHS["mamba2-2.7b"].grad_accum == 2


# ---------------------------------------------------------------------------
# the SSD block: ssm_forward, its cache, ssm_decode_step
# ---------------------------------------------------------------------------


def block_params(cfg, seed):
    """``ssm_defs`` drawn by the reference's scheme, with ``a_log``,
    ``dt_bias``, ``d_skip`` and the gated norm's scale drawn too, so every
    head decays at its own rate."""
    tree = draw(cfg, seed, jssm.ssm_defs(cfg))
    rng = np.random.default_rng(seed + 100)
    h, di = cfg.ssm_nheads, cfg.ssm_dinner
    tree["a_log"] = rng.normal(0.0, 0.5, h).astype(np.float32)
    tree["dt_bias"] = rng.normal(-0.5, 0.5, h).astype(np.float32)
    tree["d_skip"] = rng.normal(1.0, 0.3, h).astype(np.float32)
    tree["norm"] = rng.normal(0.0, 0.2, di).astype(np.float32)
    tree["conv_b_x"] = np.asarray(jnp.asarray(rng.normal(0.0, 0.1, di), cfg.dtype))
    return tree


def block_run(cfg):
    """The reference's prefill of one SSD block with its cache, then one
    decode step from that cache, jitted."""
    def run(p, x, x_next):
        out, cache = jssm.ssm_forward(p, x, cfg, return_cache=True)
        y, new = jssm.ssm_decode_step(p, x_next, cache, cfg)
        return out, cache, y, new
    return reference_jit.jit(run)


@pytest.fixture(scope="module")
def block_program():
    """:func:`block_run`, one jitted program per configuration."""
    made = {}

    def get(cfg):
        if cfg not in made:
            made[cfg] = block_run(cfg)
        return made[cfg]

    return get


def block_case(dtype, length, seed=0):
    """mamba2's SMOKE block in ``dtype``, inputs (2, length, D) and the next
    token (2, D), for both packages."""
    jcfg, tcfg = configs("mamba2-2.7b", dtype=dtype)
    tree = block_params(jcfg, seed)
    rng = np.random.default_rng(seed + length)
    x = rng.standard_normal((2, length, jcfg.d_model)).astype(np.float32)
    x_next = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tp = Params({k: tmodel._tensor(v, torch.device("cpu")) for k, v in tree.items()})
    return (jcfg, tcfg, tree, tp, (jnp.asarray(x, dtype), jnp.asarray(x_next, dtype)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(x_next).to(tdt)))


#: L = 4 chunks of 32; one chunk shorter than ssm_chunk and than W - 1
BLOCK_LENGTHS = {"4-chunks": 128, "under-chunk-and-conv": 2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BLOCK_LENGTHS)
def test_ssm_forward_cache_and_decode_step_match(block_program, case, dtype):
    length = BLOCK_LENGTHS[case]
    jcfg, tcfg, tree, tp, (jx, jn), (tx, tn) = block_case(dtype, length)
    jout, jcache, jy, jnew = block_program(jcfg)(tree, jx, jn)
    tol = BLOCK_TOL[dtype]

    out, cache = tssm.ssm_forward(tp, tx, tcfg, return_cache=True)
    assert out.dtype == tx.dtype and tuple(out.shape) == tx.shape
    assert torch.equal(tssm.ssm_forward(tp, tx, tcfg), out)
    assert_scaled_close(out, jout, tol, "ssm_forward")
    c = jcfg.ssm_dinner + 2 * jcfg.ssm_state
    assert cache["state"].dtype == torch.float32
    assert tuple(cache["state"].shape) == (2, jcfg.ssm_nheads, jcfg.ssm_state, jcfg.ssm_headdim)
    assert_scaled_close(cache["state"], jcache["state"], tol, "state")
    # the conv tail is the projections' output before the conv, left-padded
    # with zeros when L < W - 1
    assert cache["conv"].dtype == tx.dtype and tuple(cache["conv"].shape) == (2, 3, c)
    assert_scaled_close(cache["conv"], jcache["conv"], tol, "conv")
    if length < jcfg.conv_width - 1:
        pad = jcfg.conv_width - 1 - length
        assert not cache["conv"][:, :pad].any() and cache["conv"][:, pad:].abs().sum() > 0

    y, new = tssm.ssm_decode_step(tp, tn, {k: v.clone() for k, v in cache.items()}, tcfg)
    assert y.dtype == tn.dtype and tuple(y.shape) == tn.shape
    assert_scaled_close(y, jy, tol, "ssm_decode_step")
    assert_scaled_close(new["state"], jnew["state"], tol, "decode state")
    assert_scaled_close(new["conv"], jnew["conv"], tol, "decode conv")
    assert torch.equal(new["conv"][:, :-1], cache["conv"][:, 1:])


def test_ssm_forward_refuses_a_sequence_the_chunk_does_not_divide():
    """The reference asserts ``L % q == 0`` (q = min(ssm_chunk, L))."""
    jcfg, tcfg, tree, tp, (jx, _), (tx, _) = block_case("float32", 48)
    with pytest.raises(AssertionError):
        jssm.ssm_forward(tree, jx, jcfg)
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk 32"):
        tssm.ssm_forward(tp, tx, tcfg)


def test_ssd_scan_backward_is_finite_across_chunks():
    """The intra-chunk scores mask the exponent with -inf before ``exp``:
    the gradient through the masked entries is 0, not inf · 0 = nan."""
    _, tcfg, _, tp, _, (tx, _) = block_case("float32", 64)
    x = tx.clone().requires_grad_(True)
    tssm.ssm_forward(tp, x, tcfg).square().sum().backward()
    assert bool(torch.isfinite(x.grad).all()) and x.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the SMOKE models: prefill and decode, the loss, train_step, checkpoints
# ---------------------------------------------------------------------------


class Reference:
    """One SMOKE's reference parameters, its loss gradient and its serving
    run (prefill, ``pad_cache``, teacher-forced decode steps under one
    ``lax.scan``), each jitted once per shape."""

    def __init__(self, arch, dtype="float32"):
        self.jcfg, self.tcfg = configs(arch, dtype=dtype)
        self.params = draw(self.jcfg, 0)
        self.grad = reference_jit.jit(jax.value_and_grad(
            lambda p, b: jmodel.loss_fn(p, b, self.jcfg)))
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
        jp = scaled(self.params, self.jcfg, scale)
        return jp, tmodel.params_from_numpy(jp, self.tcfg, device="cpu")


@pytest.fixture(scope="module")
def reference():
    made = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in made:
            made[arch, dtype] = Reference(arch, dtype)
        return made[arch, dtype]

    return get


def cache_pairs(got, want):
    """The port's ``{kind: {k, v, state, conv}}`` leaves beside the
    reference's ``{kind: {attn: {k, v}, ssm: {state, conv}}}`` ones."""
    assert sorted(got) == sorted(want)
    out = {}
    for kind in want:
        for group, names in (("attn", ("k", "v")), ("ssm", ("state", "conv"))):
            if group in want[kind]:
                for name in names:
                    g, w = got[kind][name], np.asarray(want[kind][group][name])
                    assert g.numel() == w.size and tuple(g.shape[1:]) == w.shape[2:], name
                    out[f"{kind}/{name}"] = (g, w)
        assert sorted(got[kind]) == sorted(
            n for grp in want[kind] for n in want[kind][grp]), kind
    return out


def assert_caches_close(got, want, tol, what):
    for name, (g, w) in cache_pairs(got, want).items():
        assert_scaled_close(g, w, tol, f"{what} {name}")


def serve_port(ref, tp, tokens, forced):
    """The port's prefill, ``pad_cache`` and teacher-forced decode steps:
    (prefill logits, prefill cache, step logits, last cache)."""
    seq, steps = tokens.shape[1], forced.shape[0]
    tl, tc = tmodel.prefill(tp, {"tokens": torch.as_tensor(tokens)}, ref.tcfg)
    prefill_cache = {k: {n: t.clone() for n, t in v.items()} for k, v in tc.items()}
    tc = tmodel.pad_cache(tc, seq, seq + steps)
    logits = []
    for step in range(steps):
        sl, tc = tmodel.decode_step(tp, tc, torch.as_tensor(forced[step]), seq + step, ref.tcfg)
        logits.append(sl)
    return tl, prefill_cache, logits, tc


def serving_inputs(cfg, b, seq, steps, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, seq)).astype(np.int32),
            rng.integers(0, cfg.vocab, (steps, b)).astype(np.int32))


#: (B, prompt, decode steps): mamba2 over two chunks; hymba on a prompt of
#: 24 whose padded local cache the steps carry past the window (start > 0)
SERVING = {"mamba2-2.7b": [(2, 64, 6)], "hymba-1.5b": [(2, 24, 12)]}
SERVING_CASES = [(arch, *case) for arch, cases in SERVING.items() for case in cases]
#: the bfloat16 SMOKEs: both over two chunks; hymba's local ring of 32
#: slots wrapped by the prompt and by the steps
BF16_SERVING = {"mamba2-2.7b": (2, 64, 6), "hymba-1.5b": (2, 64, 6)}


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("arch,b,seq,steps", SERVING_CASES,
                         ids=[f"{a}-{s}" for a, _, s, _ in SERVING_CASES])
def test_prefill_and_teacher_forced_decode_match(reference, arch, b, seq, steps, scale):
    ref = reference(arch)
    jp, tp = ref.scaled(SCALES[scale])
    tokens, forced = serving_inputs(ref.jcfg, b, seq, steps)
    jl, jc, jsteps, jlast = ref.serve(jp, jnp.asarray(tokens), jnp.asarray(forced))
    tl, tc, tsteps, tlast = serve_port(ref, tp, tokens, forced)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (b, ref.jcfg.padded_vocab)
    assert_scaled_close(tl, jl, LOGIT_TOL[scale], "prefill logits")
    assert_caches_close(tc, jc, CACHE_TOL[scale], "prefill")
    for step, sl in enumerate(tsteps):
        assert_scaled_close(sl, jsteps[step], LOGIT_TOL[scale], f"step {step} logits")
    assert_caches_close(tlast, jlast, CACHE_TOL[scale], "decode")
    if arch == "mamba2-2.7b":
        assert sorted(tc) == ["global"] and sorted(tc["global"]) == ["conv", "state"]
    else:  # the local cache grown past the window by pad_cache
        assert tc["local"]["k"].shape[2] == seq < ref.jcfg.window < tlast["local"]["k"].shape[2]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_bfloat16_smoke_prefill_and_decode_match(reference, arch):
    """The SMOKE in bfloat16 (weights scaled by 0.1): the reference's dtype
    placement (conv in float32, cast back, then silu in prefill; silu in
    float32 in decode) reproduced within one bfloat16 rounding chain."""
    ref = reference(arch, "bfloat16")
    jp, tp = ref.scaled(0.1)
    b, seq, steps = BF16_SERVING[arch]
    tokens, forced = serving_inputs(ref.jcfg, b, seq, steps, seed=2)
    jl, jc, jsteps, jlast = ref.serve(jp, jnp.asarray(tokens), jnp.asarray(forced))
    tl, tc, tsteps, tlast = serve_port(ref, tp, tokens, forced)
    assert tc["global"]["state"].dtype == torch.float32
    assert tc["global"]["conv"].dtype == torch.bfloat16
    if arch == "hymba-1.5b":
        assert tc["local"]["k"].shape[2] == ref.jcfg.window < seq  # a ring, wrapped
    assert_scaled_close(tl, jl, BF16_MODEL_TOL, "prefill logits")
    for step, sl in enumerate(tsteps):
        assert_scaled_close(sl, jsteps[step], BF16_MODEL_TOL, f"step {step} logits")
    assert_caches_close(tc, jc, BF16_MODEL_TOL, "prefill")
    assert_caches_close(tlast, jlast, BF16_MODEL_TOL, "decode")


def lm_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_loss_fn_value_and_every_gradient_leaf_match(reference, arch, scale):
    """The loss over two SSD chunks and the gradient of every leaf: the
    float32 ``a_log``/``d_skip``/``dt_bias``, the convs and their biases,
    the projections, the hybrid's attention, MLP and output norms."""
    ref = reference(arch)
    jp, tp = ref.scaled(SCALES[scale])
    batch = lm_batch(ref.jcfg, 2, 64, 1)
    jl, jg = ref.grad(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = t_steps.loss_and_grads(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    ref.tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert sorted(tg) == sorted(k for k, _ in tp.named_parameters())
    assert all(tg[f"layers.0.ssm.{n}"].dtype == torch.float32
               for n in ("a_log", "d_skip", "dt_bias"))
    assert tg["layers.0.ssm.a_log"].abs().sum() > 0
    assert_trees_close(tmodel.params_to_tree(tg, ref.tcfg), jg, GRAD_TOL[scale], "grad")


def test_train_step_matches_the_reference():
    """One step of the reference's ``build_step`` train branch (on a 1 x 1
    host mesh) and of ``steps.train_step`` from the same parameters (the
    weight matrices scaled by 0.1): mamba2 over two micro-batches, as its
    published config trains; the float32 SSD leaves stay float32.  (The
    hybrid layer's gradients are held by the loss test; AdamW and the
    micro-batch loop do not depend on the family.)"""
    jcfg, tcfg = configs("mamba2-2.7b", grad_accum=2)
    jp = scaled(draw(jcfg, 2), jcfg, 0.1)
    jo = j_adamw_init(jp, jcfg.opt_dtype)
    fn = j_steps.build_step(jcfg, j_shapes.SHAPES["train_4k"], multi_pod=False)[0]
    batch = lm_batch(jcfg, 4, 64, 4)
    with jax.set_mesh(j_mesh.make_host_mesh()):
        jp1, jo1, jm1 = reference_jit.jit(fn)(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tmodel.params_from_numpy(jp, tcfg, device="cpu")
    to = adamw_init(tp, tcfg.opt_dtype)
    lr = float(cosine_schedule(to["step"], peak_lr=3e-4, warmup=2000, total=100_000))
    tp, to, metrics = t_steps.train_step(tp, to, {k: torch.from_numpy(v) for k, v in batch.items()},
                                         tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm1["loss"]), rtol=1e-6)
    assert tp.layers[0].ssm.a_log.dtype == torch.float32
    assert_trees_close(tmodel.params_to_tree(tp, tcfg), jp1, 1e-5, "params", 2 * lr)
    for mom, tol in (("m", 3e-3), ("v", 6e-3)):
        assert all(t.dtype == torch.float32 for t in to[mom].values())
        assert_trees_close(tmodel.params_to_tree(to[mom], tcfg), jo1[mom], tol, mom)
    assert int(to["step"]) == int(jo1["step"]) == 1


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_params_round_trip_and_checkpoints_cross(arch, tmp_path):
    """``params_from_numpy`` then ``params_to_tree`` gives the reference's
    tree back bit for bit (the float32 SSD leaves, the stacked convs), as
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
    assert np.array_equal(params.layers[1].ssm.conv_x.numpy(),
                          tree["groups"]["global"]["ssm"]["conv_x"][-1, -1])
    state = {"m": tree, "v": scaled(tree, jcfg, 2.0), "step": np.int32(3)}
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


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_params_and_init_cache_follow_the_reference(arch):
    """The port's own draw: ``a_log``/``dt_bias`` zeros and ``d_skip`` ones in
    float32 as the reference's initialiser makes them, the same generator
    seed the same weights; ``init_cache``'s leaves, shapes and dtypes."""
    cfg, jcfg = SMOKES[arch], J_SMOKES[arch]
    a, again = (tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
                for _ in range(2))
    s = a.layers[0].ssm
    assert all(t.dtype == torch.float32 for t in (s.a_log, s.d_skip, s.dt_bias, s.norm))
    assert not s.a_log.any() and not s.dt_bias.any() and bool((s.d_skip == 1).all())
    assert s.conv_x.dtype == cfg.torch_dtype and s.conv_x.std() > 0.3
    for (name, x), (_, y) in zip(a.named_parameters(), again.named_parameters()):
        assert torch.equal(x, y), name
    got = tmodel.init_cache(cfg, 3, 40, device="cpu")
    want = jmodel.init_cache(jcfg, 3, 40)
    for name, (g, w) in cache_pairs(got, want).items():
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype) and not g.any(), name


# ---------------------------------------------------------------------------
# pad_cache's rule on the SSD leaves, and the serving engine
# ---------------------------------------------------------------------------


#: (arch, B, prompt, what breaks): a prompt of H = 16 tokens (the SMOKEs'
#: SSD head count) or of B tokens pads the SSD leaves; the others decode
TRAP_CASES = [("mamba2-2.7b", 2, 16, "H"), ("mamba2-2.7b", 4, 4, "B"),
              ("mamba2-2.7b", 2, 8, None), ("mamba2-2.7b", 3, 32, None),
              ("hymba-1.5b", 2, 16, "H"), ("hymba-1.5b", 3, 3, "B")]


@pytest.mark.parametrize("arch,b,seq,breaks", TRAP_CASES,
                         ids=[f"{a[:5]}-b{b}-prompt{s}" for a, b, s, _ in TRAP_CASES])
def test_pad_cache_trap_fails_exactly_where_the_reference_fails(reference, arch, b, seq, breaks):
    ref = reference(arch)
    jp, tp = ref.scaled(1.0)
    tokens, forced = serving_inputs(ref.jcfg, b, seq, 2, seed=seq)
    assert ref.jcfg.ssm_nheads == 16
    if breaks is None:
        jl, jc, jsteps, jlast = ref.serve(jp, jnp.asarray(tokens), jnp.asarray(forced))
        tl, tc, tsteps, tlast = serve_port(ref, tp, tokens, forced)
        assert_scaled_close(tl, jl, LOGIT_TOL["reference-init"], "prefill logits")
        for step, sl in enumerate(tsteps):
            assert_scaled_close(sl, jsteps[step], LOGIT_TOL["reference-init"], f"step {step}")
        assert_caches_close(tlast, jlast, CACHE_TOL["reference-init"], "decode")
        return
    # the reference's first decode step fails on the padded leaf's shape
    with pytest.raises(TypeError, match="incompatible shapes|Cannot concatenate"):
        ref.serve(jp, jnp.asarray(tokens), jnp.asarray(forced))
    tl, tc = tmodel.prefill(tp, {"tokens": torch.as_tensor(tokens)}, ref.tcfg)
    padded = tmodel.pad_cache(tc, seq, seq + 2)
    leaf = "state" if breaks == "H" else "conv"
    assert tc["global"][leaf].shape[-3] == seq and padded["global"][leaf].shape[-3] == seq + 2
    with pytest.raises(ValueError, match=f"SSD '{leaf}' cache .*pad_cache grew its axis -3"):
        tmodel.decode_step(tp, padded, torch.as_tensor(forced[0]), seq, ref.tcfg)


def test_serving_engine_matches_the_reference():
    """hymba's SMOKE (attention and SSD state in every layer) through both
    serving engines on the same requests and parameters (the reference's
    initialiser): every request's tokens, admission and stats equal, the
    slices all released.  Prompts of 12 tokens: neither H nor a wave's
    batch."""
    jcfg, tcfg = configs("hymba-1.5b")
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


# ---------------------------------------------------------------------------
# the measurements the tolerances above state
# ---------------------------------------------------------------------------


def measure():
    """Print the port's errors and the reference's own spread (a one-ulp
    nudge of its drawn weights) for each held quantity, worst over the
    cases, relative to the quantity's largest magnitude."""
    worst = {}

    def note(key, port, spread):
        p, s = worst.get(key, (0.0, 0.0))
        worst[key] = (max(p, port), max(s, spread))

    get = {}

    def ref_of(arch, dtype="float32"):
        if (arch, dtype) not in get:
            get[arch, dtype] = Reference(arch, dtype)
        return get[arch, dtype]

    blocks = {}
    for dtype in ("float32", "bfloat16"):
        for length in BLOCK_LENGTHS.values():
            jcfg, tcfg, tree, tp, (jx, jn), (tx, tn) = block_case(dtype, length)
            prog = blocks.setdefault(dtype, block_run(jcfg))
            want = prog(tree, jx, jn)
            nudge = {k: (np.asarray(jnp.nextafter(jnp.asarray(v), jnp.asarray(np.inf, v.dtype)))
                         if v.ndim > 1 else v) for k, v in tree.items()}
            spread = prog(nudge, jx, jn)
            out, cache = tssm.ssm_forward(tp, tx, tcfg, return_cache=True)
            y, new = tssm.ssm_decode_step(tp, tn, cache, tcfg)
            for g, w, s in zip((out, cache["state"], y, new["state"]),
                               (want[0], want[1]["state"], want[2], want[3]["state"]),
                               (spread[0], spread[1]["state"], spread[2], spread[3]["state"])):
                note(f"block {dtype}", scaled_err(g, w), scaled_err(s, w))

    for arch, cases in SERVING.items():
        for (b, seq, steps) in cases:
            ref = ref_of(arch)
            for scale in SCALES:
                jp, tp = ref.scaled(SCALES[scale])
                tokens, forced = serving_inputs(ref.jcfg, b, seq, steps)
                want = ref.serve(jp, jnp.asarray(tokens), jnp.asarray(forced))
                spread = ref.serve(nudged(jp, ref.jcfg), jnp.asarray(tokens), jnp.asarray(forced))
                got = serve_port(ref, tp, tokens, forced)
                for i in (0, 2):
                    gs = got[i] if i == 0 else torch.stack(got[i])
                    note(f"logits {scale}", scaled_err(gs, want[i]), scaled_err(spread[i], want[i]))
                for i in (1, 3):
                    pairs = cache_pairs(got[i], want[i])
                    spairs = cache_pairs(got[i], spread[i])
                    for name in pairs:
                        note(f"cache {scale}", scaled_err(*pairs[name]),
                             scaled_err(spairs[name][1], pairs[name][1]))
        ref = ref_of(arch, "bfloat16")
        jp, tp = ref.scaled(0.1)
        b, seq, steps = BF16_SERVING[arch]
        tokens, forced = serving_inputs(ref.jcfg, b, seq, steps, seed=2)
        want = ref.serve(jp, jnp.asarray(tokens), jnp.asarray(forced))
        spread = ref.serve(nudged(jp, ref.jcfg), jnp.asarray(tokens), jnp.asarray(forced))
        got = serve_port(ref, tp, tokens, forced)
        note("bf16 logits", scaled_err(got[0], want[0]), scaled_err(spread[0], want[0]))
        note("bf16 logits", scaled_err(torch.stack(got[2]), want[2]), scaled_err(spread[2], want[2]))
        for i in (1, 3):
            pairs, spairs = cache_pairs(got[i], want[i]), cache_pairs(got[i], spread[i])
            for name in pairs:
                note("bf16 cache", scaled_err(*pairs[name]),
                     scaled_err(spairs[name][1], pairs[name][1]))
        ref = ref_of(arch)
        for scale in SCALES:
            jp, tp = ref.scaled(SCALES[scale])
            batch = lm_batch(ref.jcfg, 2, 64, 1)
            jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
            _, jg = ref.grad(jp, jb_)
            _, sg = ref.grad(nudged(jp, ref.jcfg), jb_)
            _, tg = t_steps.loss_and_grads(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                           ref.tcfg)
            got, want, spread = (flat(tmodel.params_to_tree(tg, ref.tcfg)),
                                 flat(jax.tree.map(np.asarray, jg)),
                                 flat(jax.tree.map(np.asarray, sg)))
            for path in want:
                if np.abs(want[path]).max() > 0:
                    note(f"grad {scale}", scaled_err(got[path], want[path]),
                         scaled_err(spread[path], want[path]))
    for key, (port, spread) in worst.items():
        print(f"{key}: port {port:.2e}, reference spread {spread:.2e}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    measure()
