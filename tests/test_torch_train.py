"""The port's training path equals the reference package's on the CPU.

Inputs come from numpy seeds; parameters are the reference's
``init_params`` tree carried over with ``params_from_numpy``; torch runs
float32 on one thread.  Each tolerance below is stated against what was
measured here:

* ``cosine_schedule``: rtol 1e-6 (float32 ``cos`` of two libraries).
* ``adamw_update`` fed the same gradients, 3 steps: float32 parameters
  and moments at 1e-5 of each leaf's largest magnitude (measured
  ≤ 2.4e-7); bfloat16 leaves at 2^-7 of it, one bfloat16 ulp (a float32
  result one ulp apart may round to the neighbouring bfloat16; measured 0).
* Synthetic batches: byte for byte.
* ``blockwise_attention`` and ``chunked_ce_loss``: float32 outputs and
  gradients at 1e-5 of each tensor's largest magnitude (measured
  ≤ 5.5e-7); bfloat16 ones at 2^-7 of it (measured ≤ 1.4e-5, one
  bfloat16 ulp of a small element).
* ``loss_fn``: the loss at rtol 1e-6.  Its gradients at 3e-3 of each
  leaf's largest magnitude under the reference's initialiser, and at 2e-5
  with the weight matrices scaled by 0.1.  The initialiser draws every
  stacked layer weight at std 0.25 (its fan-in is the leading ``n_groups``
  axis), so the smoke model's attention logits reach |456|: its softmax
  turns a one-ulp difference in a logit into ~1e-4 of the probability.
  The worst gradient leaf measured differs by 7.0e-4 of its largest
  magnitude here (``ln1``, gelu with a padded vocabulary) and by 1.1e-3
  in ``train_step``'s draw; with the weights scaled by 0.1 by 2.6e-6.
* ``train_step``: the loss at rtol 1e-6; the new parameters at 1e-5 of
  each leaf's largest magnitude plus 2·lr, the most by which one element's
  Adam step can differ (a gradient element near 0 whose sign differs);
  measured ≤ 0.8·lr (one float32 ulp at |p| ~ 1; the learning rate of steps
  0 and 1 under the reference's schedule is 0 and 1.5e-7).  The moments
  at 3e-3 (``m`` = 0.1·g; measured 1.1e-3) and 6e-3 (``v`` = 0.05·g²,
  twice g's relative error; measured 1.9e-3) of the leaf's largest
  magnitude.
* The 20-step loss curve of the smoke launcher: every step's loss within
  1e-5 of the reference's (measured 1.9e-6), with the weight matrices
  scaled by 0.1.  Under the reference's initialiser the curve is chaotic:
  the reference itself, rerun from its parameters nudged by one float32
  ulp, moves by up to 0.047 within 20 steps (measured), as the port does
  (Adam moves an element by ~±lr wherever its gradient's sign differs).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_jit

from repro import checkpoint as jckpt
from repro.configs import SMOKES as J_SMOKES
from repro.data import make_batch_iterator as j_batches
from repro.launch import mesh as j_mesh
from repro.launch import shapes as j_shapes
from repro.launch import steps as j_steps
from repro.models import common as jcommon
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_schedule as j_cosine

from repro_torch import checkpoint as tckpt
from repro_torch.data import make_batch_iterator as t_batches
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "llama3.2-1b"
#: the smoke config and the two dense variants of tests/test_torch_model.py
VARIANTS = {
    "smoke": {},
    "geglu-3-layers": dict(mlp="geglu", n_layers=3),
    "gelu-padded-vocab": dict(mlp="gelu", vocab=500, d_ff=384),
}


def configs(variant="smoke", **change):
    base = dataclasses.asdict(J_SMOKES[ARCH])
    base.update(VARIANTS[variant], **change)
    return JConfig(**base), TConfig(**base)


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
    got, want = as_f32(got), as_f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + atol, f"{what}: max err {err:.3e} > {tol:g} x {scale:.3e} + {atol:g}"


def assert_trees_close(got_tree, want_tree, tol, what="", atol=0.0):
    got, want = flat(got_tree), flat(want_tree)
    assert sorted(got) == sorted(want), what
    for path in want:
        assert_scaled_close(got[path], want[path], tol, f"{what} {'/'.join(path)}", atol)


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 180])
def test_cosine_schedule_matches(step):
    """Steps 0, mid-warm-up, warm-up, mid-decay, total and beyond, as an int
    and as an int32 tensor."""
    kw = dict(peak_lr=3e-3, warmup=10, total=100)
    want = float(j_cosine(jnp.int32(step), **kw))
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = cosine_schedule(s, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert float(j_cosine(step, **kw)) == want


def random_tree(rng, dtype):
    shapes = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5, 7)}, "e": (1, 6)}
    return jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32).astype(dtype),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


def named(tree, dtype):
    return {"/".join(k): torch.from_numpy(np.array(v, np.float32)).to(dtype)
            for k, v in flat(tree).items()}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["no-clip", "clip"])
def test_adamw_update_matches_on_the_same_gradients(param_dtype, moment_dtype, grad_scale):
    rng = np.random.default_rng(7)
    jdt = jnp.dtype(param_dtype)
    tdt = getattr(torch, param_dtype)
    jp = jax.tree.map(jnp.asarray, random_tree(rng, jdt))
    tp = named(jp, tdt)
    jo = j_adamw_init(jp, moment_dtype)
    to = adamw_init(tp, moment_dtype)
    assert to["step"].dtype == torch.int32 and int(to["step"]) == 0
    for step in range(3):
        g = jax.tree.map(lambda a: (grad_scale * a).astype(jdt), random_tree(rng, np.float32))
        gnorm = np.sqrt(sum(float(np.sum(np.square(np.asarray(x, np.float32))))
                            for x in jax.tree.leaves(g)))
        assert (gnorm > 1.0) == (grad_scale > 1), gnorm  # the clip engaged or not
        lr = float(j_cosine(jnp.int32(step), peak_lr=1e-2, warmup=1, total=3))
        jp, jo = j_adamw_update(jp, jax.tree.map(jnp.asarray, g), jo, lr=lr)
        _, to = adamw_update(tp, named(g, tdt), to, lr=lr)
        for what, got, want, dt in (("p", tp, jp, param_dtype), ("m", to["m"], jo["m"], moment_dtype),
                                    ("v", to["v"], jo["v"], moment_dtype)):
            tol = 1e-5 if dt == "float32" else 2.0 ** -7
            for path, w in flat(want).items():
                assert str(got["/".join(path)].dtype) == f"torch.{dt}"
                assert_scaled_close(got["/".join(path)], w, tol, f"step {step} {what} {path}")
        assert int(to["step"]) == int(jo["step"]) == step + 1


def test_adamw_update_is_not_torch_optim():
    """Decoupled decay added to the update, in float32: one step from
    m = v = 0 moves each element by lr·(sign(g) + wd·p), to 1e-6 (eps
    takes 2e-7 of the step where |g| = 0.05)."""
    p = {"w": torch.tensor([1.0, -2.0, 0.5])}
    g = {"w": torch.tensor([0.3, -0.1, 0.05])}
    state = adamw_init(p)
    adamw_update(p, g, state, lr=0.1, weight_decay=0.1, grad_clip=1e9)
    want = torch.tensor([1.0, -2.0, 0.5]) - 0.1 * (torch.tensor([1.0, -1.0, 1.0])
                                                  + 0.1 * torch.tensor([1.0, -2.0, 0.5]))
    torch.testing.assert_close(p["w"], want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change", [{}, dict(frontend="vision", num_patches=4),
                                    dict(encdec=True)], ids=["dense", "vision", "encdec"])
def test_batches_are_byte_identical(change):
    jcfg, tcfg = configs(**change)
    jit, tit = j_batches(jcfg, 3, 17, seed=5), t_batches(tcfg, 3, 17, seed=5)
    for _ in range(3):
        want, got = next(jit), next(tit)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert ("patches" in want) == bool(change.get("frontend"))
    assert ("frames" in want) == bool(change.get("encdec"))


# ---------------------------------------------------------------------------
# layers: flash attention, chunked loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,dtype", [
    (dict(b=2, s=64, h=4, kv=2, d=16, blk_q=16, blk_k=16, causal=True), "float32"),
    (dict(b=2, s=64, h=4, kv=2, d=16, blk_q=16, blk_k=16, causal=True), "bfloat16"),
    (dict(b=1, s=64, h=3, kv=3, d=32, blk_q=32, blk_k=16, causal=True), "float32"),
    (dict(b=1, s=32, h=8, kv=2, d=16, blk_q=8, blk_k=32, causal=False), "float32"),
], ids=["g2-16x16-f32", "g2-16x16-bf16", "g1-32x16-f32", "g4-8x32-noncausal-f32"])
def test_blockwise_attention_forward_and_vjp_match(layout, dtype):
    lay = dict(layout)
    b, s, h, kv, d = (lay.pop(k) for k in ("b", "s", "h", "kv", "d"))
    rng = np.random.default_rng(11)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, kv, d)).astype(np.float32) for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jo, vjp = jax.vjp(lambda q, k, v: jcommon.blockwise_attention(q, k, v, **lay),
                      *(jnp.asarray(a, jdt) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, jdt))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    to = tcommon.blockwise_attention(tq, tk, tv, **lay)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert to.dtype == tdt
    assert_scaled_close(to, jo, tol, "o")
    for name, got, want in zip("qkv", tgrads, jgrads):
        assert got.dtype == tdt
        assert_scaled_close(got, want, tol, f"d{name}")


def test_blockwise_attention_refuses_the_window():
    """The call that was refused before the sliding window was ported
    (S = 8, window 4, one tile) now equals the reference's windowed
    attention; both paths at other shapes are held in
    ``tests/test_torch_dense_options.py``."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((1, 8, 2, 4)).astype(np.float32)
    want = reference_jit.jit(lambda q, k, v: jcommon.blockwise_attention(q, k, v, window=4))(
        x, x[:, :, :1], x[:, :, :1])
    t = torch.from_numpy(x)
    got = tcommon.blockwise_attention(t, t[:, :, :1], t[:, :, :1], window=4)
    assert_scaled_close(got, want, 1e-5, "o")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_ce_loss_value_and_grads_match(dtype):
    """Four chunks of 16, -1 labels, 200 valid rows of a 256-row embedding."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    embed = (0.3 * rng.standard_normal((256, 32))).astype(np.float32)
    labels = rng.integers(0, 200, (2, 64)).astype(np.int32)
    labels[0, :7] = -1
    labels[1, 40:] = -1
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jl, jg = jax.value_and_grad(
        lambda x, e: jcommon.chunked_ce_loss(x, e, jnp.asarray(labels), chunk=16, valid_vocab=200),
        argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(embed, jdt))
    tx, te = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, embed))
    tl = tcommon.chunked_ce_loss(tx, te, torch.from_numpy(labels), chunk=16, valid_vocab=200)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for name, got, want in zip(("x", "embed"), torch.autograd.grad(tl, (tx, te)), jg):
        assert got.dtype == tdt
        assert_scaled_close(got, want, tol, f"d{name}")


# ---------------------------------------------------------------------------
# model: loss and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def carried(request):
    jcfg, tcfg = configs(request.param)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    grad_fn = reference_jit.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, b, jcfg)))
    return request.param, jcfg, tcfg, jp, grad_fn


def lm_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    return tokens, labels


@pytest.mark.parametrize("weight_scale", [1.0, 0.1], ids=["reference-init", "tamed"])
def test_loss_fn_value_and_every_gradient_leaf_match(carried, weight_scale):
    name, jcfg, tcfg, jp, grad_fn = carried
    jp = jax.tree.map(lambda a: a * weight_scale if a.ndim > 1 else a, jp)
    tp = tmodel.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tokens, labels = lm_batch(jcfg, 2, 64, 1)
    jl, jg = grad_fn(jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    tl, tg = t_steps.loss_and_grads(
        tp, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert sorted(tg) == sorted(k for k, _ in tp.named_parameters())
    assert_trees_close(tmodel.params_to_tree(tg, tcfg), jax.tree.map(np.asarray, jg),
                       3e-3 if weight_scale == 1.0 else 2e-5, name)
    # training leaves the serving model frozen
    assert not any(p.requires_grad for p in tp.parameters())


@pytest.mark.parametrize("change", [{}, dict(qk_norm=True, post_norm=True, mlp="gelu"),
                                    dict(family="moe", n_experts=4, topk=2),
                                    dict(family="hybrid", frontend="vision"),
                                    dict(encdec=True, n_enc_layers=2)],
                         ids=["smoke", "norms-gelu", "moe", "hybrid-vision", "encdec"])
def test_param_count_is_the_references(change):
    """The launcher's ``[train] ... M params`` line and the model FLOPs
    count the reference's way (unpadded vocabulary rows)."""
    jcfg, tcfg = configs(**change)
    assert tcfg.param_count() == jcfg.param_count()


def test_loss_fn_refuses_the_other_families():
    """Every family's loss is ported now (the vision loss in
    ``tests/test_torch_dense_options.py``, the encdec loss held against the
    reference here and in ``tests/test_torch_encdec.py``); what stays
    refused is a training forward asked for a cache, in both stacks."""
    from repro_torch.models import encdec, transformer

    _, tcfg = configs()
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             "labels": torch.zeros((1, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="no cache"):
        transformer.forward(tp, batch, tcfg, train=True, return_cache=True)

    jcfg = J_SMOKES["whisper-large-v3"]
    wcfg = TConfig(**dataclasses.asdict(jcfg))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    wp = tmodel.params_from_numpy(jax.tree.map(np.asarray, jp), wcfg, device="cpu")
    rng = np.random.default_rng(2)
    wb = {"frames": rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32),
          "tokens": rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32),
          "labels": rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)}
    want = reference_jit.jit(lambda p, b: jmodel.loss_fn(p, b, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in wb.items()})
    got = tmodel.loss_fn(wp, {k: torch.from_numpy(v) for k, v in wb.items()}, wcfg)
    assert got.dtype == torch.float32
    # the reference's initialiser: the loss within the rtol 1e-5 measured
    # in tests/test_torch_encdec.py (its own spread 1.0e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    enc = encdec.encode(wp, torch.from_numpy(wb["frames"]), wcfg)
    with pytest.raises(ValueError, match="no cache"):
        encdec.dec_forward(wp, torch.from_numpy(wb["tokens"]), enc, wcfg, train=True,
                           return_cache=True)


def test_params_to_tree_inverts_params_from_numpy(carried):
    _, _, tcfg, jp, _ = carried
    tree = jax.tree.map(np.asarray, jp)
    got = flat(tmodel.params_to_tree(tmodel.params_from_numpy(tree, tcfg, device="cpu"), tcfg))
    want = flat(tree)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert np.array_equal(got[path].numpy(), w), path


# ---------------------------------------------------------------------------
# launch: train_step, the launcher, checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,accum", [("smoke", 1), ("smoke", 2), ("gelu-padded-vocab", 2)])
def test_train_step_matches_the_reference(variant, accum):
    """Two steps of the reference's ``build_step`` train branch (on a 1 x 1
    host mesh) and of ``steps.train_step``, from the same parameters and
    the reference's parameters and optimizer state carried over after its
    first step (``opt_state_from_numpy``)."""
    jcfg, tcfg = configs(variant, grad_accum=accum)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(2))
    jo = j_adamw_init(jp, jcfg.opt_dtype)
    fn = j_steps.build_step(jcfg, j_shapes.SHAPES["train_4k"], multi_pod=False)[0]
    batches = [lm_batch(jcfg, 4, 32, seed) for seed in (4, 5)]
    with jax.set_mesh(j_mesh.make_host_mesh()):
        step = reference_jit.jit(fn)
        jp1, jo1, jm1 = step(jp, jo, {"tokens": jnp.asarray(batches[0][0]),
                                      "labels": jnp.asarray(batches[0][1])})
        jp2, jo2, jm2 = step(jp1, jo1, {"tokens": jnp.asarray(batches[1][0]),
                                        "labels": jnp.asarray(batches[1][1])})
    np_tree = lambda t: jax.tree.map(np.asarray, t)

    tp = tmodel.params_from_numpy(np_tree(jp), tcfg, device="cpu")
    to = adamw_init(tp, tcfg.opt_dtype)
    for (tokens, labels), jloss, jpn, jon in ((batches[0], jm1, jp1, jo1), (batches[1], jm2, jp2, jo2)):
        lr = float(cosine_schedule(to["step"], peak_lr=3e-4, warmup=2000, total=100_000))
        tp, to, metrics = t_steps.train_step(
            tp, to, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}, tcfg)
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss["loss"]), rtol=1e-6)
        assert_trees_close(tmodel.params_to_tree(tp, tcfg), np_tree(jpn), 1e-5, "params", 2 * lr)
        for mom, tol in (("m", 3e-3), ("v", 6e-3)):
            assert_trees_close(tmodel.params_to_tree(to[mom], tcfg), np_tree(jon[mom]), tol, mom)
        assert int(to["step"]) == int(jon["step"])
        # carry the reference's state over for the next step
        tp = tmodel.params_from_numpy(np_tree(jpn), tcfg, device="cpu")
        to = tmodel.opt_state_from_numpy(np_tree(jon), tcfg, device="cpu")


def test_smoke_loss_curve_matches_the_reference_loop(capsys):
    """``launch/train.py``'s loop (``--smoke --steps 20 --batch 8 --seq
    64``, lr 3e-3) against the reference launcher's jitted step, both from
    the reference's parameters of seed 0 with the weight matrices scaled by
    0.1 (see the module docstring: under the unscaled initialiser the
    reference's own curve is chaotic at the 1e-2 level)."""
    jcfg, tcfg = configs()
    steps, batch, seq, lr = 20, 8, 64, 3e-3
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a * 0.1 if a.ndim > 1 else a, jp)
    tp = tmodel.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")

    @reference_jit.jit
    def step(params, opt, b):
        loss, grads = jax.value_and_grad(lambda p: jmodel.loss_fn(p, b, jcfg))(params)
        rate = j_cosine(opt["step"], peak_lr=lr, warmup=10, total=steps)
        params, opt = j_adamw_update(params, grads, opt, lr=rate)
        return params, opt, loss

    jo, data, want = j_adamw_init(jp, jcfg.opt_dtype), j_batches(jcfg, batch, seq, seed=0), []
    for _ in range(steps):
        jp, jo, loss = step(jp, jo, {k: jnp.asarray(v) for k, v in next(data).items()})
        want.append(float(loss))

    _, opt, got = t_train.train_loop(tp, tcfg, steps=steps, batch=batch, seq=seq, lr=lr,
                                     seed=0, log_every=10)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < got[0] - 0.1  # it learns
    assert int(opt["step"]) == steps
    out = capsys.readouterr().out
    assert re.findall(r"\[train\] step +(\d+) loss", out) == ["0", "10", "19"]


def test_launcher_checkpoint_restores_in_both_packages(tmp_path, capsys):
    """``train.main(..., device="cpu")`` prints the reference's lines, and
    its checkpoint restores into the reference's abstract tree; a
    checkpoint the reference writes restores into the port's tree."""
    path = tmp_path / "port.npz"
    ok = t_train.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
                       "--log-every", "1", "--checkpoint", str(path)], device="cpu")
    assert isinstance(ok, (bool, np.bool_))
    out = capsys.readouterr().out
    jcfg, tcfg = configs()
    assert f"[train] llama-smoke: {jcfg.param_count()/1e6:.1f}M params" in out
    assert len(re.findall(r"\[train\] step +\d+ loss \d+\.\d{4} \(\d+\.\d\ds/step\)", out)) == 3
    assert f"[train] saved checkpoint to {path}" in out
    assert re.search(r"\[train\] loss \d+\.\d{4} -> \d+\.\d{4} \((LEARNING|flat)\)", out)
    restored, step = jckpt.load_checkpoint(path, jmodel.abstract_params(jcfg))
    assert step == 3
    template = tmodel.params_to_tree(
        tmodel.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu"), tcfg)
    port_tree, _ = tckpt.load_checkpoint(path, template)
    assert_trees_close(port_tree, jax.tree.map(np.asarray, restored), 0.0, "port -> reference")

    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(9))
    jckpt.save_checkpoint(tmp_path / "ref.npz", jp, step=7)
    tree, step = tckpt.load_checkpoint(tmp_path / "ref.npz", template)
    assert step == 7
    tp = tmodel.params_from_numpy(tree, tcfg, device="cpu")
    assert_trees_close(tmodel.params_to_tree(tp, tcfg), jax.tree.map(np.asarray, jp), 0.0,
                       "reference -> port")


def test_launcher_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        t_train.main(["--arch", ARCH, "--smoke", "--steps", "1"])
