"""The port's encoder-decoder family and learned positions equal the
reference package's on the CPU.

``repro_torch.models.encdec`` against ``repro.models.encdec`` at the
whisper-large-v3 SMOKE (2 + 2 layers, d 256, 4 heads over 4 KV heads:
G = 1), in float32 and bfloat16: the sinusoidal table, the encoder, the
prefill's logits and ``self``/``cross`` caches, teacher-forced decode
with frames = prompt (``pad_cache`` grows the cross cache, whose zero keys
enter the reference's softmax) and with frames != prompt, the loss and
every gradient leaf, ``train_step``, the parameter and optimizer-state
round trips and checkpoints across the packages; a llama SMOKE with
``pos="learned"``; the ``decode_attention`` plain version at G = 1; and
the registry.  Parameters are drawn by numpy with the reference's
initialiser scheme and handed to both packages; torch runs on one
thread.  Each reference program is jitted once per shape through
``tests/reference_jit.py``.

Tolerances, relative to the quantity's largest magnitude, against what was
measured on the CPU (``python tests/test_torch_encdec.py`` prints the
port's errors and the reference's own spread: its result moved by a
one-ulp nudge of every drawn weight), worst over the cases:

* ``sincos_positions``: byte for byte.
* Encoder states in float32: 1e-4 under the reference's initialiser
  (port 3.2e-5; spread 1.4e-5) and 1e-5 with the weight matrices scaled by
  0.1 (port 6.8e-7; spread 9.5e-7); in bfloat16 (scaled) 2^-6 (port
  7.4e-3; spread 5.0e-2, one bfloat16 ulp of every weight).
* Prefill and decode logits: 5e-3 under the reference's initialiser (port
  2.5e-3; spread 1.4e-3: the initialiser's std-0.7 stacked weights drive
  the decoder's attention logits into the hundreds) and 2e-5 scaled (port
  9.1e-7; spread 1.7e-6).  Every cache leaf after the prefill and after
  the last step: 2e-3 (port 4.0e-4; spread 5.4e-4) and 2e-5 (port 9.0e-7;
  spread 1.4e-6).
* The bfloat16 SMOKE (scaled): logits and caches at 2^-4 (port 9.9e-3 and
  7.6e-3; spread 1.1e-1 and 8.9e-2).
* ``loss_fn`` over 32 frames and 16 tokens: the loss at rtol 1e-5 under the
  reference's initialiser (port 1.6e-6; spread 1.0e-6) and 1e-6 scaled
  (port 0; spread 0); every gradient leaf at 5e-2 (port 1.2e-2; spread
  2.4e-2) and 2e-5 (port 2.4e-6; spread 2.9e-6).
* ``train_step``, scaled, two micro-batches: the loss at rtol 1e-6; the
  new parameters at 1e-5 of scale + 2·lr; the moments at 3e-3 (``m``) and
  6e-3 (``v``) of scale, as ``tests/test_torch_train.py``.
* The llama SMOKE with learned positions: logits and caches at 1e-4 under
  the reference's initialiser (port 9.4e-6; spread 2.1e-5) and 2e-5 scaled
  (port 1.4e-6; spread 1.6e-6).
* ``decode_attention``'s plain version at G = 1 against the reference's
  ``ref.py``: 1e-6 absolute in float32, one bfloat16 ulp of the output
  (2^-8 of its largest magnitude) in bfloat16.

The reference's ``pad_cache`` grows every cache leaf whose axis -3 equals
the prompt length, the cross cache (L, B, S_enc, KV, hd) too when the frame
count equals the prompt length; its decode then attends over the zero keys
(``kv_pos = arange(S_enc)``, ``pos = S_enc``), each adding a logit of 0.
The port keeps the rule: :func:`test_pad_cache_grows_the_cross_cache_as_the_reference`
shows both packages moved by the zero keys alike.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_jit
from test_torch_ssm import assert_scaled_close, assert_trees_close, draw, flat, nudged, scaled
from test_torch_ssm import scaled_err

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.kernels.decode_attention.ref import decode_attention_ref as j_attention_ref
from repro.launch import mesh as j_mesh
from repro.launch import shapes as j_shapes
from repro.launch import steps as j_steps
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JConfig
from repro.optim import adamw_init as j_adamw_init

from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch.kernels.decode_attention import decode_attention as T
from repro_torch.kernels.decode_attention.ref import decode_attention_ref as t_attention_ref
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as tencdec
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw_init, cosine_schedule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "whisper-large-v3"
SCALES = {"reference-init": 1.0, "tamed": 0.1}
ENC_TOL = {("float32", "reference-init"): 1e-4, ("float32", "tamed"): 1e-5,
           ("bfloat16", "tamed"): 2.0 ** -6}
LOGIT_TOL = {"reference-init": 5e-3, "tamed": 2e-5}
CACHE_TOL = {"reference-init": 2e-3, "tamed": 2e-5}
LOSS_RTOL = {"reference-init": 1e-5, "tamed": 1e-6}
GRAD_TOL = {"reference-init": 5e-2, "tamed": 2e-5}
LEARNED_TOL = {"reference-init": 1e-4, "tamed": 2e-5}
BF16_MODEL_TOL = 2.0 ** -4

#: (B, frames, prompt, decode steps): frames = prompt, so pad_cache grows
#: the cross cache by the steps' slots; frames != prompt, not grown
SERVING = {"grown-cross": (2, 16, 16, 4), "unpadded-cross": (2, 32, 16, 4)}


def configs(arch=ARCH, **change):
    base = dataclasses.asdict(jconfigs.SMOKES[arch])
    base.update(change)
    return JConfig(**base), TConfig(**base)


def serving_inputs(cfg, b, frames, prompt, steps, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab, (b, prompt)).astype(np.int32),
            rng.integers(0, cfg.vocab, (steps, b)).astype(np.int32))


class Reference:
    """The whisper SMOKE's reference parameters (in ``dtype``), its encoder,
    its loss gradient and its serving run (prefill, ``pad_cache``,
    teacher-forced decode steps under one ``lax.scan``), each jitted once
    per shape."""

    def __init__(self, dtype="float32", arch=ARCH, **change):
        self.jcfg, self.tcfg = configs(arch, dtype=dtype, **change)
        self.params = draw(self.jcfg, 0)
        self.encode = reference_jit.jit(lambda p, f: jencdec.encode(p, f, self.jcfg))
        self.grad = reference_jit.jit(jax.value_and_grad(
            lambda p, b: jmodel.loss_fn(p, b, self.jcfg)))
        self.serve = reference_jit.jit(self._serve)

    def _serve(self, params, batch, forced):
        cfg, seq = self.jcfg, batch["tokens"].shape[1]
        logits, cache = jmodel.prefill(params, batch, cfg)
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

    def get(dtype="float32", arch=ARCH, **change):
        key = (dtype, arch, tuple(sorted(change.items())))
        if key not in made:
            made[key] = Reference(dtype, arch, **change)
        return made[key]

    return get


def batch_of(frames, tokens, to):
    out = {"tokens": to(tokens)}
    if frames is not None:
        out["frames"] = to(frames)
    return out


def serve_port(ref, tp, batch, forced):
    """The port's prefill, ``pad_cache`` and teacher-forced decode steps:
    (prefill logits, prefill cache, step logits, last cache)."""
    seq, steps = batch["tokens"].shape[1], forced.shape[0]
    tl, tc = tmodel.prefill(tp, batch, ref.tcfg)
    prefill_cache = {k: {n: t.clone() for n, t in v.items()} for k, v in tc.items()}
    tc = tmodel.pad_cache(tc, seq, seq + steps)
    logits = []
    for step in range(steps):
        sl, tc = tmodel.decode_step(tp, tc, torch.as_tensor(forced[step]), seq + step, ref.tcfg)
        logits.append(sl)
    return tl, prefill_cache, logits, tc


def serve_both(ref, jp, tp, frames, tokens, forced):
    want = ref.serve(jp, batch_of(frames, tokens, jnp.asarray), jnp.asarray(forced))
    got = serve_port(ref, tp, batch_of(frames, tokens, torch.as_tensor), forced)
    return got, want


def cache_pairs(got, want):
    """The port's cache leaves beside the reference's, by name."""
    assert sorted(got) == sorted(want)
    out = {}
    for kind in want:
        assert sorted(got[kind]) == sorted(want[kind]), kind
        for name in want[kind]:
            g, w = got[kind][name], np.asarray(want[kind][name])
            assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype), (kind, name)
            out[f"{kind}/{name}"] = (g, w)
    return out


def assert_caches_close(got, want, tol, what):
    for name, (g, w) in cache_pairs(got, want).items():
        assert_scaled_close(g, w, tol, f"{what} {name}")


# ---------------------------------------------------------------------------
# the registry and the sinusoidal table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ARCHS", "SMOKES", "ASSIGNED", "LONG_CONTEXT_OK"])
def test_registry_is_the_references(name):
    got, want = getattr(tconfigs, name), getattr(jconfigs, name)
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for arch in want:
            assert dataclasses.asdict(got[arch]) == dataclasses.asdict(want[arch]), arch
            assert got[arch].param_count() == want[arch].param_count(), arch
    else:
        assert got == want


@pytest.mark.parametrize("s,d", [(16, 256), (1536, 1280), (7, 3), (1, 2)])
def test_sincos_positions_are_the_references_bytes(s, d):
    got, want = tcommon.sincos_positions(s, d), jcommon.sincos_positions(s, d)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the encoder, prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,scale", list(ENC_TOL))
def test_encode_matches(reference, dtype, scale):
    """The frames and the sinusoidal table each cast to the model dtype,
    then added; non-causal attention over the frames, ``enc_norm``."""
    ref = reference(dtype)
    jp, tp = ref.scaled(SCALES[scale])
    frames = np.random.default_rng(7).standard_normal((2, 32, ref.jcfg.d_model)).astype(np.float32)
    want = ref.encode(jp, jnp.asarray(frames))
    got = tencdec.encode(tp, torch.from_numpy(frames), ref.tcfg)
    assert got.dtype == ref.tcfg.torch_dtype and tuple(got.shape) == frames.shape
    assert_scaled_close(got, want, ENC_TOL[dtype, scale], "encoder states")


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("case", SERVING)
def test_prefill_and_teacher_forced_decode_match(reference, case, scale):
    ref = reference()
    jp, tp = ref.scaled(SCALES[scale])
    b, n_frames, prompt, steps = SERVING[case]
    frames, tokens, forced = serving_inputs(ref.jcfg, b, n_frames, prompt, steps)
    (tl, tc, tsteps, tlast), (jl, jc, jsteps, jlast) = serve_both(ref, jp, tp, frames, tokens,
                                                                 forced)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (b, ref.jcfg.padded_vocab)
    assert tuple(tc["cross"]["k"].shape) == (2, b, n_frames, 4, 64)
    assert_scaled_close(tl, jl, LOGIT_TOL[scale], "prefill logits")
    assert_caches_close(tc, jc, CACHE_TOL[scale], "prefill")
    for step, sl in enumerate(tsteps):
        assert_scaled_close(sl, jsteps[step], LOGIT_TOL[scale], f"step {step} logits")
    assert_caches_close(tlast, jlast, CACHE_TOL[scale], "decode")
    grown = n_frames == prompt
    assert tlast["cross"]["k"].shape[2] == n_frames + (steps if grown else 0)
    # the decode never writes the cross cache: the grown slots stay zero
    assert torch.equal(tlast["cross"]["k"][:, :, :n_frames], tc["cross"]["k"])
    assert not tlast["cross"]["v"][:, :, n_frames:].any()


def test_bfloat16_smoke_prefill_and_decode_match(reference):
    """The SMOKE in bfloat16 (weights scaled by 0.1), frames = prompt: the
    bf16 frames plus the bf16 table, the embedding scaled, then
    ``pos_embed`` added in bf16, as the reference orders them."""
    ref = reference("bfloat16")
    jp, tp = ref.scaled(0.1)
    frames, tokens, forced = serving_inputs(ref.jcfg, 2, 16, 16, 4, seed=2)
    (tl, tc, tsteps, tlast), (jl, jc, jsteps, jlast) = serve_both(ref, jp, tp, frames, tokens,
                                                                 forced)
    assert tc["self"]["k"].dtype == tc["cross"]["k"].dtype == torch.bfloat16
    assert_scaled_close(tl, jl, BF16_MODEL_TOL, "prefill logits")
    for step, sl in enumerate(tsteps):
        assert_scaled_close(sl, jsteps[step], BF16_MODEL_TOL, f"step {step} logits")
    assert_caches_close(tc, jc, BF16_MODEL_TOL, "prefill")
    assert_caches_close(tlast, jlast, BF16_MODEL_TOL, "decode")


def test_pad_cache_grows_the_cross_cache_as_the_reference(reference):
    """Frames = prompt: ``pad_cache`` grows the cross cache with zero keys
    in both packages, and the first decode step's logits move by the same
    amount in both against a decode over the cross cache left unpadded
    (weights scaled by 0.1, so the zero keys' logit of 0 registers)."""
    ref = reference()
    jp, tp = ref.scaled(0.1)
    frames, tokens, forced = serving_inputs(ref.jcfg, 2, 16, 16, 1, seed=3)
    tl, tc = tmodel.prefill(tp, batch_of(frames, tokens, torch.as_tensor), ref.tcfg)
    jl, jc = jmodel.prefill(jp, batch_of(frames, tokens, jnp.asarray), ref.jcfg)
    padded = {"t": tmodel.pad_cache(tc, 16, 20), "j": jmodel.pad_cache(jc, 16, 20)}
    assert padded["t"]["cross"]["k"].shape[2] == padded["j"]["cross"]["k"].shape[2] == 20
    # the self cache grown alone: the cross cache as the prefill left it
    unpadded = {"t": {"self": padded["t"]["self"],
                      "cross": {n: t.clone() for n, t in tc["cross"].items()}},
                "j": {"self": padded["j"]["self"], "cross": jc["cross"]}}
    token, pos = forced[0], 16
    out = {}
    for name, caches in (("padded", padded), ("unpadded", unpadded)):
        cache = {k: {n: t.clone() for n, t in v.items()} for k, v in caches["t"].items()}
        t_logits, _ = tmodel.decode_step(tp, cache, torch.as_tensor(token), pos, ref.tcfg)
        j_logits, _ = jmodel.decode_step(jp, caches["j"], jnp.asarray(token), jnp.int32(pos),
                                         ref.jcfg)
        assert_scaled_close(t_logits, j_logits, LOGIT_TOL["tamed"], f"{name} logits")
        out[name] = (t_logits.numpy(), np.asarray(j_logits))
    t_moved = np.abs(out["padded"][0] - out["unpadded"][0]).max()
    j_moved = np.abs(out["padded"][1] - out["unpadded"][1]).max()
    assert t_moved > 1e-3 and abs(t_moved - j_moved) <= 1e-5 * np.abs(out["padded"][1]).max()


# ---------------------------------------------------------------------------
# training: the loss and its gradients, train_step, the launcher
# ---------------------------------------------------------------------------


def lm_batch(cfg, b, frames, s, seed):
    rng = np.random.default_rng(seed)
    out = {"frames": rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32),
           "tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    out["labels"][0, :5] = -1
    return out


@pytest.mark.parametrize("scale", SCALES)
def test_loss_fn_value_and_every_gradient_leaf_match(reference, scale):
    """The loss over 32 frames and 16 tokens and the gradient of every
    leaf: both layer stacks, both norms, the embedding (tied head) and the
    learned positions (rows past the prompt get none)."""
    ref = reference()
    jp, tp = ref.scaled(SCALES[scale])
    batch = lm_batch(ref.jcfg, 2, 32, 16, 1)
    jl, jg = ref.grad(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = t_steps.loss_and_grads(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    ref.tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL[scale])
    assert sorted(tg) == sorted(k for k, _ in tp.named_parameters())
    assert tg["pos_embed"][:16].abs().sum() > 0 and not tg["pos_embed"][16:].any()
    assert_trees_close(tmodel.params_to_tree(tg, ref.tcfg), jg, GRAD_TOL[scale], "grad")
    assert not any(p.requires_grad for p in tp.parameters())


def test_train_step_matches_the_reference():
    """One step of the reference's ``build_step`` train branch (on a 1 x 1
    host mesh) and of ``steps.train_step`` from the same parameters (the
    weight matrices scaled by 0.1), the batch of frames and tokens split
    into two micro-batches."""
    jcfg, tcfg = configs(grad_accum=2)
    jp = scaled(draw(jcfg, 2), jcfg, 0.1)
    jo = j_adamw_init(jp, jcfg.opt_dtype)
    fn = j_steps.build_step(jcfg, j_shapes.SHAPES["train_4k"], multi_pod=False)[0]
    batch = lm_batch(jcfg, 4, 16, 16, 4)
    with jax.set_mesh(j_mesh.make_host_mesh()):
        jp1, jo1, jm1 = reference_jit.jit(fn)(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tmodel.params_from_numpy(jp, tcfg, device="cpu")
    to = adamw_init(tp, tcfg.opt_dtype)
    lr = float(cosine_schedule(to["step"], peak_lr=3e-4, warmup=2000, total=100_000))
    tp, to, metrics = t_steps.train_step(tp, to, {k: torch.from_numpy(v) for k, v in batch.items()},
                                         tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm1["loss"]), rtol=1e-6)
    assert_trees_close(tmodel.params_to_tree(tp, tcfg), jp1, 1e-5, "params", 2 * lr)
    for mom, tol in (("m", 3e-3), ("v", 6e-3)):
        assert_trees_close(tmodel.params_to_tree(to[mom], tcfg), jo1[mom], tol, mom)
    assert int(to["step"]) == int(jo1["step"]) == 1


def test_smoke_launcher_trains_whisper(capsys):
    """``launch/train.py --arch whisper-large-v3 --smoke`` on the CPU: the
    synthetic stream's frames reach the encoder, every loss is finite."""
    t_train.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
                  "--log-every", "1"], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[train] whisper-smoke:")
    losses = [float(line.split()[4]) for line in lines if line.startswith("[train] step")]
    assert len(losses) == 3 and all(np.isfinite(losses))


# ---------------------------------------------------------------------------
# parameters, optimizer state, checkpoints, caches
# ---------------------------------------------------------------------------


def test_params_round_trip_and_checkpoints_cross(tmp_path):
    """``params_from_numpy`` then ``params_to_tree`` gives the reference's
    tree back bit for bit (both layer stacks on their one layer axis), as
    ``opt_state_from_numpy`` does the reference's AdamW moments; a
    checkpoint the reference writes loads into the port, and one the port
    writes loads into the reference."""
    jcfg, tcfg = configs()
    tree = draw(jcfg, 5)
    params = tmodel.params_from_numpy(tree, tcfg, device="cpu")
    assert len(params.enc_layers) == jcfg.n_enc_layers and len(params.dec_layers) == jcfg.n_layers
    got, want = flat(tmodel.params_to_tree(params, tcfg)), flat(tree)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert np.array_equal(got[path].numpy(), w), path
    assert np.array_equal(params.dec_layers[1].cross_attn.wk.numpy(),
                          tree["dec_layers"]["cross_attn"]["wk"][1])
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


def test_init_params_and_init_cache_follow_the_reference():
    """The port's own draw: the reference's leaves, shapes and dtypes, norms
    zero, the same generator seed the same weights, each drawn weight at
    the scheme's spread (the stacked leaves' fan-in is the layer count);
    ``init_cache``'s halves of ``seq_len``."""
    cfg, jcfg = tconfigs.SMOKES[ARCH], jconfigs.SMOKES[ARCH]
    a, again = (tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
                for _ in range(2))
    got, want = flat(tmodel.params_to_tree(a, cfg)), flat(jmodel.abstract_params(jcfg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape and str(got[path].dtype)[6:] == str(w.dtype)
    for (name, x), (_, y) in zip(a.named_parameters(), again.named_parameters()):
        assert torch.equal(x, y), name
    assert not a.enc_norm.any() and not a.dec_layers[0].ln_x.any()
    assert abs(float(a.dec_layers[0].cross_attn.wq.std()) * 2 ** 0.5 - 1) < 0.05
    assert abs(float(a.pos_embed.std()) * 32768 ** 0.5 - 1) < 0.05
    got = tmodel.init_cache(cfg, 3, 40, device="cpu")
    want = jmodel.init_cache(jcfg, 3, 40)
    for name, (g, w) in cache_pairs(got, want).items():
        assert not g.any() and g.shape[2] == 20, name


# ---------------------------------------------------------------------------
# learned positions on the decoder stack; decode_attention at G = 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", SCALES)
def test_learned_positions_on_the_decoder_stack_match(reference, scale):
    """The llama SMOKE with ``pos="learned"``: ``pos_embed[:s]`` added at
    the prefill, ``pos_embed[pos]`` at each decode step, no rotation."""
    ref = reference("float32", "llama3.2-1b", pos="learned")
    jp, tp = ref.scaled(SCALES[scale])
    assert tuple(tp.pos_embed.shape) == (32768, ref.jcfg.d_model)
    _, tokens, forced = serving_inputs(ref.jcfg, 2, 0, 16, 4, seed=5)
    (tl, tc, tsteps, tlast), (jl, jc, jsteps, jlast) = serve_both(ref, jp, tp, None, tokens,
                                                                 forced)
    assert_scaled_close(tl, jl, LEARNED_TOL[scale], "prefill logits")
    for step, sl in enumerate(tsteps):
        assert_scaled_close(sl, jsteps[step], LEARNED_TOL[scale], f"step {step} logits")
    for kind in ("prefill", "decode"):
        got, want = (tc, jc) if kind == "prefill" else (tlast, jlast)
        for name in ("k", "v"):
            assert_scaled_close(got["global"][name], want["global"]["attn"][name],
                                LEARNED_TOL[scale], f"{kind} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_version_at_g1_matches_the_oracle(dtype):
    """whisper's decode shapes at G = 1 (K = H = 4): the self cache of 20
    slots read up to ``pos + 1`` and the cross cache read whole, through
    the wrapper (the plain version on the CPU, no launch counted), against
    the reference's ``ref.py``."""
    rng = np.random.default_rng(11)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    before = T.decode_attention.launches
    for s, lengths in ((20, [17, 17]), (16, [16, 16])):
        q = rng.standard_normal((2, 4, 64)).astype(np.float32)
        k, v = (rng.standard_normal((2, s, 4, 64)).astype(np.float32) for _ in range(2))
        n = np.asarray(lengths, np.int32)
        want = np.asarray(j_attention_ref(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                          length=jnp.asarray(n)), np.float32)
        ts = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
        got = T.decode_attention(*ts, torch.from_numpy(n))
        assert got.dtype == tdt and torch.equal(got, t_attention_ref(*ts, torch.from_numpy(n)))
        atol = 1e-6 if dtype == "float32" else 2.0 ** -8 * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    assert T.decode_attention.launches == before


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

    made = {}

    def ref_of(dtype="float32", arch=ARCH, **change):
        key = (dtype, arch, tuple(sorted(change.items())))
        if key not in made:
            made[key] = Reference(dtype, arch, **change)
        return made[key]

    frames = np.random.default_rng(7).standard_normal((2, 32, 256)).astype(np.float32)
    for dtype, scale in ENC_TOL:
        ref = ref_of(dtype)
        jp, tp = ref.scaled(SCALES[scale])
        want = ref.encode(jp, jnp.asarray(frames))
        spread = ref.encode(nudged(jp, ref.jcfg), jnp.asarray(frames))
        got = tencdec.encode(tp, torch.from_numpy(frames), ref.tcfg)
        note(f"encode {dtype} {scale}", scaled_err(got, want), scaled_err(spread, want))

    def serving(ref, scale, frames_, tokens, forced, tag):
        jp, tp = ref.scaled(scale)
        got, want = serve_both(ref, jp, tp, frames_, tokens, forced)
        want = list(want)
        spread = list(ref.serve(nudged(jp, ref.jcfg), batch_of(frames_, tokens, jnp.asarray),
                                jnp.asarray(forced)))
        for i in (0, 2):
            g = got[i] if i == 0 else torch.stack(got[i])
            note(f"{tag} logits", scaled_err(g, want[i]), scaled_err(spread[i], want[i]))
        for i in (1, 3):
            if "self" not in want[i]:  # the decoder stack's {"global": {"attn": {k, v}}}
                want[i], spread[i] = ({"global": {n: np.asarray(x).reshape((-1,) + x.shape[2:])
                                                  for n, x in w["global"]["attn"].items()}}
                                      for w in (want[i], spread[i]))
            pairs, spairs = cache_pairs(got[i], want[i]), cache_pairs(got[i], spread[i])
            for name in pairs:
                note(f"{tag} cache", scaled_err(*pairs[name]),
                     scaled_err(spairs[name][1], pairs[name][1]))

    ref = ref_of()
    for case, (b, nf, prompt, steps) in SERVING.items():
        inputs = serving_inputs(ref.jcfg, b, nf, prompt, steps)
        for scale in SCALES:
            serving(ref, SCALES[scale], *inputs, scale)
    serving(ref_of("bfloat16"), 0.1, *serving_inputs(ref.jcfg, 2, 16, 16, 4, seed=2), "bf16")
    learned = ref_of("float32", "llama3.2-1b", pos="learned")
    _, tokens, forced = serving_inputs(learned.jcfg, 2, 0, 16, 4, seed=5)
    for scale in SCALES:
        serving(learned, SCALES[scale], None, tokens, forced, f"learned {scale}")

    batch = lm_batch(ref.jcfg, 2, 32, 16, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for scale in SCALES:
        jp, tp = ref.scaled(SCALES[scale])
        jl, jg = ref.grad(jp, jb)
        sl, sg = ref.grad(nudged(jp, ref.jcfg), jb)
        tl, tg = t_steps.loss_and_grads(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                        ref.tcfg)
        note(f"loss {scale}", abs(float(tl) - float(jl)) / abs(float(jl)),
             abs(float(sl) - float(jl)) / abs(float(jl)))
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
