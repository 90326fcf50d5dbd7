"""The port's dense transformer equals the reference package's on the same
parameters: the reference's ``init_params`` tree is carried over with
``params_from_numpy`` and both run the same seeded tokens.

Tolerances (float32 on both sides, summed in another order by another
library): the logits elementwise at atol = rtol = 1e-4; the KV caches at
1e-4 of the cache's largest magnitude.  The caches cannot be held
elementwise: the reference's initialiser draws every stacked layer weight
at std 0.25 (its fan-in is the leading ``n_groups`` axis), so the smoke
model's attention logits reach |456| (std 126), its hidden states 5.8e3
and the second layer's K/V 45; a one-ulp difference in the first layer's
output then moves a near-zero K/V element of the next layer by ~4e-4,
i.e. 1e-5 of the cache's scale (measured on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SMOKES as J_SMOKES
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JConfig

from repro_torch.configs import ARCHS, SMOKES, get_config
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig as TConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(atol=1e-4, rtol=1e-4)


def assert_cache_close(got: torch.Tensor, want: np.ndarray) -> None:
    want = want.reshape(got.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * scale


#: the smoke config and two dense variants that reach the other MLPs
#: (geglu over three layers; plain gelu with a padded vocab)
VARIANTS = {
    "smoke": {},
    "geglu-3-layers": dict(mlp="geglu", n_layers=3),
    "gelu-padded-vocab": dict(mlp="gelu", vocab=500, d_ff=384),
}


def configs(variant):
    base = dataclasses.asdict(J_SMOKES["llama3.2-1b"])
    base.update(VARIANTS[variant])
    return JConfig(**base), TConfig(**base)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def carried(request):
    jcfg, tcfg = configs(request.param)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, tree, tmodel.params_from_numpy(tree, tcfg, device="cpu")


def restack(params, cfg):
    """The port's module in the reference's tree layout (leading
    ``(n_groups, n_global)`` axes on the layer leaves)."""
    def leaves(module, prefix=()):
        out = {}
        for name, p in module.named_parameters():
            out[prefix + tuple(name.split("."))] = p.detach()
        return out

    layers = [leaves(layer) for layer in params.layers]
    stacked = {}
    for path in layers[0]:
        t = torch.stack([lay[path] for lay in layers]).reshape(
            (cfg.n_groups, cfg.group_pattern[1]) + tuple(layers[0][path].shape))
        node = stacked
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return {"embed": params.embed.detach(), "final_norm": params.final_norm.detach(),
            "groups": {"global": stacked}}


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


#: the architectures the port runs: every one of the reference's registry
PORTED = ["gemma3-12b", "granite-moe-3b-a800m", "grok-1-314b", "hymba-1.5b", "llama3.2-1b",
          "llama3.2-1b-sw", "mamba2-2.7b", "paligemma-3b", "qwen3-14b", "starcoder2-15b",
          "whisper-large-v3"]


def test_configs_are_the_references():
    assert sorted(ARCHS) == PORTED and sorted(SMOKES) == PORTED
    for arch in ARCHS:
        assert dataclasses.asdict(ARCHS[arch]) == dataclasses.asdict(J_ARCHS[arch])
        assert dataclasses.asdict(SMOKES[arch]) == dataclasses.asdict(J_SMOKES[arch])
        assert get_config(arch) is ARCHS[arch]
    cfg = ARCHS["llama3.2-1b"]
    assert (cfg.padded_vocab, cfg.group_pattern, cfg.n_groups, cfg.torch_dtype) == (
        J_ARCHS["llama3.2-1b"].padded_vocab, (0, 1), 16, torch.bfloat16)
    for arch in ("gemma3-12b", "llama3.2-1b-sw"):
        assert (ARCHS[arch].group_pattern, ARCHS[arch].n_groups) == (
            J_ARCHS[arch].group_pattern, J_ARCHS[arch].n_groups)
    # the reference gives the sliding-window variant the windowless SMOKE
    assert SMOKES["llama3.2-1b-sw"] is SMOKES["llama3.2-1b"]
    assert sorted(J_ARCHS) == PORTED and get_config("whisper-large-v3").encdec
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("whisper-tiny")


@pytest.mark.parametrize("arch", PORTED)
def test_full_width_params_match_reference_shapes_and_dtypes(arch):
    """At the published widths, on the meta device: every leaf of the
    port's module has the reference's shape and dtype."""
    got = flat(tmodel.params_to_tree(tmodel.init_params(ARCHS[arch], None, device="meta"),
                                     ARCHS[arch]))
    want = flat(jmodel.abstract_params(J_ARCHS[arch]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert str(got[path].dtype).removeprefix("torch.") == str(w.dtype), path
    n = sum(int(np.prod(w.shape)) for w in want.values())
    assert n == sum(p.numel() for p in tmodel.init_params(ARCHS[arch], None, "meta").parameters())


def test_init_params_follows_the_reference_scheme():
    cfg = SMOKES["llama3.2-1b"]
    a = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = tmodel.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    got, again, other = (flat(restack(p, cfg)) for p in (a, b, c))
    want = flat(jax.tree.map(np.asarray, jmodel.init_params(J_SMOKES["llama3.2-1b"],
                                                            jax.random.PRNGKey(0))))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == str(w.dtype)
        assert torch.equal(g, again[path])
        if not w.any():  # norms: zeros in both
            assert not g.any()
            continue
        assert not torch.equal(g, other[path])
        # normal × scale / sqrt(fan_in): the same spread as the reference's draw
        assert abs(float(g.std()) / float(w.std()) - 1) < 0.05, path


def test_params_from_numpy_round_trips(carried):
    _, tcfg, _, tree, params = carried
    got = flat(restack(params, tcfg))
    want = flat(tree)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert np.array_equal(got[path].numpy(), w), path


def test_params_from_numpy_keeps_bfloat16_bits():
    base = dataclasses.asdict(J_SMOKES["llama3.2-1b"])
    base["dtype"] = "bfloat16"
    jcfg, tcfg = JConfig(**base), TConfig(**base)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(3)))
    got = flat(restack(tmodel.params_from_numpy(tree, tcfg, device="cpu"), tcfg))
    for path, w in flat(tree).items():
        assert str(got[path].dtype).removeprefix("torch.") == str(w.dtype)
        assert np.array_equal(got[path].float().numpy(), w.astype(np.float32)), path


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def test_prefill_and_teacher_forced_decode_match(carried):
    jcfg, tcfg, jp, _, tp = carried
    b, plen, steps = 3, 16, 8
    prompt = tokens(jcfg, (b, plen), 0)
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg)
    tl, tc = tmodel.prefill(tp, {"tokens": torch.as_tensor(prompt)}, tcfg)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (b, jcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert sorted(tc) == ["global"]
    for name in ("k", "v"):
        assert_cache_close(tc["global"][name], np.asarray(jc["global"]["attn"][name]))

    jc = jmodel.pad_cache(jc, plen, plen + steps)
    tc = tmodel.pad_cache(tc, plen, plen + steps)
    forced = tokens(jcfg, (steps, b), 1)
    for step in range(steps):
        jl, jc = jmodel.decode_step(jp, jc, jnp.asarray(forced[step]), jnp.int32(plen + step), jcfg)
        tl, tc = tmodel.decode_step(tp, tc, torch.as_tensor(forced[step]), plen + step, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        assert_cache_close(tc["global"][name], np.asarray(jc["global"]["attn"][name]))


def test_pad_cache_matches():
    """The reference's rule on the port's ``{kind: {"k", "v"}}`` caches:
    every cache of ``prefill_len`` slots grows (zeros after the prompt),
    and a cache of another length passes through unchanged."""
    cfg = SMOKES["llama3.2-1b"]
    rng = np.random.default_rng(4)
    k = rng.standard_normal((cfg.n_layers, 2, 5, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    jcache = {"global": {"attn": {"k": jnp.asarray(k.reshape((cfg.n_layers, 1) + k.shape[1:])),
                                  "v": jnp.asarray(2 * k.reshape((cfg.n_layers, 1) + k.shape[1:]))}}}
    got = tmodel.pad_cache({"global": {"k": torch.as_tensor(k), "v": torch.as_tensor(2 * k)}},
                           5, 9)["global"]
    want = jmodel.pad_cache(jcache, 5, 9)["global"]["attn"]
    for name in ("k", "v"):
        assert tuple(got[name].shape) == (cfg.n_layers, 2, 9, cfg.n_kv_heads, cfg.head_dim)
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]).reshape(got[name].shape))
    again = tmodel.pad_cache({"global": got}, 5, 12)["global"]
    assert all(again[name] is got[name] for name in ("k", "v"))
    assert jmodel.pad_cache(jmodel.pad_cache(jcache, 5, 9), 5, 12)["global"]["attn"]["k"].shape[-3] == 9


def test_init_cache_matches_reference_layout():
    cfg = SMOKES["llama3.2-1b"]
    got = tmodel.init_cache(cfg, 3, 11, device="cpu")
    want = jmodel.init_cache(J_SMOKES["llama3.2-1b"], 3, 11)["global"]["attn"]
    assert sorted(got) == ["global"]
    for name in ("k", "v"):
        assert got["global"][name].dtype == torch.float32 and not got["global"][name].any()
        assert got["global"][name].shape == (
            np.asarray(want[name]).reshape(-1, *want[name].shape[2:])).shape


@pytest.mark.parametrize("change", [
    dict(pos="learned"),
    "whisper-large-v3",
], ids=["learned-positions", "encdec-whisper"])
def test_unported_variants_raise(change):
    """The two variants this test once saw refused, learned positions and
    the encdec family, are ported (ROADMAP.md §1 (b4); held against the
    reference in ``tests/test_torch_encdec.py``): their parameter trees
    equal the reference's leaf for leaf.  What raises now is what the
    reference refuses as well: a prompt past the 32,768 learned positions,
    and the encdec model fed no ``frames`` (the serving engine's prefill
    passes only tokens, in both packages)."""
    if isinstance(change, str):
        jcfg = J_SMOKES[change]
    else:
        base = dataclasses.asdict(J_SMOKES["llama3.2-1b"])
        base.update(change)
        jcfg = JConfig(**base)
    cfg = TConfig(**dataclasses.asdict(jcfg))
    jp = jax.tree.map(np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    params = tmodel.params_from_numpy(jp, cfg, device="cpu")
    got, want = flat(tmodel.params_to_tree(params, cfg)), flat(jp)
    assert sorted(got) == sorted(want) and ("pos_embed",) in want
    for path, w in want.items():
        assert np.array_equal(got[path].numpy(), w), path
    if cfg.encdec:
        tokens = np.zeros((1, 4), np.int32)
        with pytest.raises(KeyError, match="frames"):
            jmodel.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
        with pytest.raises(KeyError, match="frames"):
            tmodel.prefill(params, {"tokens": torch.as_tensor(tokens)}, cfg)
    else:
        from repro.models import transformer as jtransformer
        from repro_torch.models import transformer as ttransformer

        tokens = np.zeros((1, 32769), np.int32)
        with pytest.raises(ValueError, match="broadcast"):
            jtransformer.embed_inputs(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
        with pytest.raises(RuntimeError, match="size of tensor"):
            ttransformer.embed_inputs(params, {"tokens": torch.as_tensor(tokens)}, cfg)
