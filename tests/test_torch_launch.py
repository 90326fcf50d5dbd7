"""The port's launch tooling (``sharding.py``, ``launch/mesh.py``,
``launch/shapes.py``, ``launch/steps.py::build_step``, ``launch/dryrun.py``)
against the reference package's.

Exact: ``SHAPES``; the batch, cache and decode specs' shapes and dtypes
(meta tensors against the reference's ``ShapeDtypeStruct``s) for every
assigned arch × runnable shape; the rules, ``resolve``, the parameter,
batch and cache ``PartitionSpec``s by leaf path, for both ``multi_pod``;
``runnable`` and the ``--opt`` table; the meshes; the barrier's backward
dtype.  The port keeps a cache kind's layers on one leading axis where the
reference keeps two, ``(n_groups, n_local | n_global)``, and drops the
reference's ``attn``/``ssm`` level of the cache tree: a reference cache
leaf is compared with its first two axes merged (its spec with its first
entry, ``None``, dropped) under its path without that level.

``sharding.constraint`` on a ``fake`` 2 × 2 process group's mesh places
by mesh dim (``Shard``/``Replicate``, the pair ``("pod", "data")``
pod-major); it stays the identity on the host mesh and without rules.
``dryrun.run_one`` on a ``fake`` group of 256 or 512 ranks places
``build_step``'s meta arguments with exactly the reference's per-device
bytes (its spec arithmetic, each dim divided, rounded up, by the product
of its spec's mesh-axis sizes).

``build_step``'s steps on the SMOKE configs against the reference's
``build_step`` functions run under ``jax.set_mesh(make_host_mesh())``,
the reference's parameters carried over.  Tolerances, by the two regimes
of ``tests/test_torch_train.py``, measured on the CPU:

* prefill and decode logits, float32 (llama3.2-1b's and hymba-1.5b's
  SMOKE, and llama's prefill under ``attn_tp``, whose K/V heads are
  repeated to the query heads): elementwise at atol = rtol = 1e-4 under
  the reference's initialiser (``tests/test_torch_model.py``'s
  tolerance; measured ≤ 2.6e-6 of the logits' largest magnitude), and at
  1e-5 of the logits' largest magnitude with the weight matrices scaled
  by 0.1 (measured ≤ 2.0e-6).
* one train step under ``bf16_grad`` on llama's SMOKE in bfloat16 (the
  barrier then casts the loss's float32 cotangent to bfloat16).  Under
  the reference's initialiser a bfloat16 step is chaotic: the reference
  rerun from its parameters nudged by one ulp moves the loss by 4.9e-4
  (relative), ``m`` by 1.27 and ``v`` by 1.0 of a leaf's largest
  magnitude, and the global norm of ``v`` by 8.1e-2 (``m``'s is set by
  the gradient clip).  So there the loss is held at rtol 1e-3 (measured
  5.1e-5) and the global norm of ``v`` at 0.2 (measured 2.7e-2).  With
  the weight matrices scaled by 0.1: the loss at rtol 2e-4 (measured
  2.5e-5; the reference's one-ulp spread 3.2e-5), ``m`` and ``v`` per
  leaf at 5e-2 of the leaf's largest magnitude (measured 1.8e-2 and
  1.7e-2; the reference's spread 3.7e-2 and 6.7e-2).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_jit

from repro import sharding as j_sharding
from repro.configs import ARCHS as J_ARCHS
from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import SMOKES as J_SMOKES
from repro.launch import dryrun as j_dryrun
from repro.launch import mesh as j_mesh
from repro.launch import shapes as j_shapes
from repro.launch import steps as j_steps
from repro.models import common as jcommon
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JConfig
from repro.optim import adamw_init as j_adamw_init

from repro_torch import sharding
from repro_torch.configs import ARCHS, ASSIGNED, LONG_CONTEXT_OK
from repro_torch.launch import dryrun, mesh, shapes, steps
from repro_torch.models import common, model as tmodel
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw_init


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PAIRS = [(arch, shape) for arch in ASSIGNED for shape in shapes.SHAPES
         if dryrun.runnable(arch, shape)]


def j_flat(tree, leaf_type=jax.sharding.PartitionSpec):
    """The reference's leaves (specs and ParamDefs kept whole) by path of
    dict keys."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, leaf_type))
    return {tuple(k.key for k in path): leaf for path, leaf in leaves}


def t_flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(t_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) else np.dtype(dt).name


def cache_view(jcfg, path, leaf):
    """A reference cache leaf's path and shape, spec or dtype as the port
    lays it out."""
    path = tuple(k for k in path if k not in ("attn", "ssm"))
    if isinstance(leaf, jax.sharding.PartitionSpec):
        leaf = tuple(leaf)
        if jcfg.encdec:
            return path, leaf
        assert leaf[0] is None
        return path, leaf[1:]
    if jcfg.encdec or not isinstance(leaf, tuple):
        return path, leaf
    return path, (leaf[0] * leaf[1],) + tuple(leaf[2:])


# ---------------------------------------------------------------------------
# Shapes, specs and rules: exact
# ---------------------------------------------------------------------------


def test_shapes_and_runnable_are_the_references():
    assert shapes.SHAPES.keys() == j_shapes.SHAPES.keys()
    for name, shape in shapes.SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(j_shapes.SHAPES[name])
    assert ASSIGNED == J_ASSIGNED
    for arch in ARCHS:
        for name in shapes.SHAPES:
            assert dryrun.runnable(arch, name) == j_dryrun.runnable(arch, name), (arch, name)
    assert not dryrun.runnable("llama3.2-1b", "long_500k") and "hymba-1.5b" in LONG_CONTEXT_OK


def test_opt_overrides_are_the_references():
    """The dry run's ``--opt`` table (``src/repro/launch/dryrun.py:176-186``,
    a branch of its ``main``, so held here entry by entry)."""
    assert dryrun.OPT_OVERRIDES == {
        "attn_tp": {"attn_tp": True, "heads_tp": "model"},
        "kvseq": {"kv_seq": "model", "kv_heads": None, "kv_head_dim": None,
                  "decode_seq_shard": True},
        "bf16grad": {"bf16_grad": True},
        "nofsdp": {"dmodel": None},
    }


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_specs_rules_and_partitions_equal_the_references(arch, shape_name):
    """For both ``multi_pod``: the rules, the batch/cache/decode specs'
    shapes and dtypes, and every ``PartitionSpec`` ``build_step`` returns
    (parameters, optimizer state, batch, cache, token, logits), by leaf
    path."""
    tcfg, jcfg, shape = ARCHS[arch], J_ARCHS[arch], shapes.SHAPES[shape_name]
    jshape = j_shapes.SHAPES[shape_name]
    for multi_pod in (False, True):
        rules = steps.rules_for(tcfg, shape, multi_pod=multi_pod)
        assert rules == j_steps.rules_for(jcfg, jshape, multi_pod=multi_pod)
        fn, args, ins, outs = steps.build_step(tcfg, shape, multi_pod=multi_pod)
        jfn, jargs, jins, jouts = j_steps.build_step(jcfg, jshape, multi_pod=multi_pod)
        assert all(isinstance(s, sharding.PartitionSpec) for s in t_flat(ins[0]).values())
        want = {k: tuple(v) for k, v in j_flat(jins[0]).items()}
        assert {k: tuple(v) for k, v in t_flat(ins[0]).items()} == want
        with sharding.use_rules(rules), j_sharding.use_rules(rules):
            assert {k: tuple(v) for k, v in t_flat(tmodel.param_specs(tcfg)).items()} == want
        if shape.kind == "decode":
            cache, jcache = args[1], jargs[1]
            want_cache = dict(cache_view(jcfg, p, tuple(v.shape)) for p, v in j_flat(jcache).items())
            assert {p: tuple(v.shape) for p, v in t_flat(cache).items()} == want_cache
            assert {p: dtype_name(v.dtype) for p, v in t_flat(cache).items()} == dict(
                cache_view(jcfg, p, dtype_name(v.dtype)) for p, v in j_flat(jcache).items())
            assert all(v.device.type == "meta" for v in t_flat(cache).values())
            want_specs = dict(cache_view(jcfg, p, v) for p, v in j_flat(jins[1]).items())
            assert {p: tuple(v) for p, v in t_flat(ins[1]).items()} == want_specs
            for got, want_leaf in ((args[2], jargs[2]), (args[3], jargs[3])):
                assert tuple(got.shape) == want_leaf.shape
                assert dtype_name(got.dtype) == dtype_name(want_leaf.dtype)
            assert tuple(ins[2]) == tuple(jins[2]) and tuple(ins[3]) == tuple(jins[3])
            assert tuple(outs[0]) == tuple(jouts[0])
            assert shapes.decode_specs(tcfg, shape)["cache"].keys() == cache.keys()
        else:
            batch = args[-1]
            jbatch = jargs[-1]
            assert batch.keys() == jbatch.keys()
            for key in jbatch:
                assert tuple(batch[key].shape) == jbatch[key].shape, key
                assert dtype_name(batch[key].dtype) == dtype_name(jbatch[key].dtype), key
                assert batch[key].device.type == "meta"
                assert tuple(ins[-1][key]) == tuple(jins[-1][key]), key
            if shape.kind == "train":
                assert {k: tuple(v) for k, v in t_flat(outs[0]).items()} == want
                assert {k: tuple(v) for k, v in t_flat(ins[1]["m"]).items()} == want
                assert tuple(ins[1]["step"]) == tuple(jins[1]["step"]) == ()
                assert tuple(outs[2]["loss"]) == tuple(jouts[2]["loss"])
                named = dict(args[0].named_parameters())
                assert args[1]["m"].keys() == named.keys()
                assert dtype_name(args[1]["v"][next(iter(named))].dtype) == tcfg.opt_dtype
            else:
                assert tuple(outs[0]) == tuple(jouts[0])
                want_specs = dict(cache_view(jcfg, p, v) for p, v in j_flat(jouts[1]).items())
                assert {p: tuple(v) for p, v in t_flat(outs[1]).items()} == want_specs
        jparams = {p: v for p, v in j_flat(jargs[0]).items()}
        tparams = t_flat(tmodel.params_to_tree(args[0], tcfg))
        assert {p: (tuple(v.shape), dtype_name(v.dtype)) for p, v in tparams.items()} == {
            p: (tuple(v.shape), dtype_name(v.dtype)) for p, v in jparams.items()}


def test_default_rules_and_resolve_are_the_references():
    for kw in (dict(), dict(multi_pod=True, n_heads=32, n_kv_heads=8),
               dict(n_heads=48, n_kv_heads=16, batch_shardable=False, shard_kv_seq=True,
                    fsdp=False)):
        rules = sharding.default_rules(**kw)
        assert rules == j_sharding.default_rules(**kw)
        axes = (None, "batch", "dmodel", "kv_heads", "unknown")
        with sharding.use_rules(rules), j_sharding.use_rules(rules):
            assert tuple(sharding.resolve(axes)) == tuple(j_sharding.resolve(axes))
            assert sharding.active_rule("ff") == j_sharding.active_rule("ff") == "model"
    assert sharding.active_rule("ff") is None and sharding.resolve(("batch",)) == (None,)
    assert repr(sharding.PartitionSpec("data", None)) == "PartitionSpec('data', None)"


def test_param_defs_carry_the_reference_axes():
    """Every ``ParamDef`` of every family carries the reference's logical
    axes, and the length check refuses a mismatch."""
    for arch in ("llama3.2-1b", "gemma3-12b", "paligemma-3b", "granite-moe-3b-a800m",
                 "hymba-1.5b", "mamba2-2.7b", "whisper-large-v3"):
        got = t_flat(tmodel.param_defs(ARCHS[arch]))
        want = j_flat(jmodel.param_defs(J_ARCHS[arch]), jcommon.ParamDef)
        assert {p: d.axes for p, d in got.items()} == {p: d.axes for p, d in want.items()}
    with pytest.raises(AssertionError):
        common.ParamDef((2, 3), ("dmodel",))


def test_meshes():
    host = mesh.make_host_mesh("cpu")
    assert host.shape == (1, 1) and host.axis_names == ("data", "model")
    assert host.devices == (torch.device("cpu"),)
    jhost = j_mesh.make_host_mesh()
    assert tuple(jhost.shape.values()) == host.shape and jhost.axis_names == host.axis_names
    for multi_pod, want in ((False, ((16, 16), ("data", "model"))),
                            (True, ((2, 16, 16), ("pod", "data", "model")))):
        m = mesh.make_production_mesh(multi_pod=multi_pod)
        assert (m.shape, m.axis_names) == want and m.devices is None
    assert (mesh.MODEL_AXIS_SIZE, mesh.DATA_AXIS_SIZE, mesh.POD_AXIS_SIZE) == (
        j_mesh.MODEL_AXIS_SIZE, j_mesh.DATA_AXIS_SIZE, j_mesh.POD_AXIS_SIZE)


def test_constraint_is_the_identity_on_one_device_and_refuses_a_larger_mesh():
    """The identity outside a rule set, on the host mesh and on a
    described mesh for a spec that names no axis larger than 1; a
    described mesh (no process group) refuses a larger axis; on a ``fake``
    2 × 2 group's mesh it places: ``Shard(i)`` on the mesh dims that the
    entry of tensor dim ``i`` names, ``Replicate()`` elsewhere, and the
    pair ``("pod", "data")`` shards one dim pod-major."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.constraint(x, "batch", "ff") is x
    rules = sharding.default_rules()
    with sharding.use_rules(rules):
        assert sharding.constraint(x, "batch", "ff") is x
        with sharding.use_mesh(mesh.make_host_mesh("cpu")):
            assert sharding.constraint(x, "batch", "ff") is x
        with sharding.use_mesh(mesh.make_production_mesh()):
            assert sharding.constraint(x, None, "seq") is x  # replicated on every axis
            with pytest.raises(RuntimeError, match="no process group of 256 ranks"):
                sharding.constraint(x, "batch", None)
    with sharding.use_mesh(mesh.make_production_mesh()):
        assert sharding.constraint(x, "batch", "ff") is x  # no rules: no placement

    dryrun.fake_process_group(4)
    try:
        m = mesh.make_mesh((2, 2), ("data", "model"), device="cpu")
        pods = mesh.make_mesh((2, 2), ("pod", "data"), device="cpu")
        t = torch.arange(16.0 * 8).reshape(16, 8)
        want = {("batch", "ff"): (Shard(0), Shard(1)), ("ff", "batch"): (Shard(1), Shard(0)),
                ("batch", None): (Shard(0), Replicate()), (None, "vocab"): (Replicate(), Shard(1)),
                (None, None): (Replicate(), Replicate())}
        with sharding.use_rules(rules), sharding.use_mesh(m):
            d = distribute_tensor(t, m.device_mesh, [Replicate(), Replicate()])
            for axes, placements in want.items():
                y = sharding.constraint(d, *axes)
                assert isinstance(y, DTensor) and tuple(y.placements) == placements, axes
                assert sharding.placements(sharding.resolve(axes), m) == placements
            with pytest.raises(TypeError, match="test_torch_launch.py"):
                sharding.constraint(t, "batch", None)
        with sharding.use_rules(sharding.default_rules(multi_pod=True)), sharding.use_mesh(pods):
            assert sharding.resolve(("batch",)) == sharding.PartitionSpec(("pod", "data"))
            d = distribute_tensor(t, pods.device_mesh, [Replicate(), Replicate()])
            y = sharding.constraint(d, "batch", None)
            assert tuple(y.placements) == (Shard(0), Shard(0))
            # rank 0 is (pod 0, data 0): rows [4·(2·0 + 0), +4)
            assert torch.equal(y.to_local(), t[:4])
        with pytest.raises(ValueError, match="otherwise than the mesh"):
            sharding.placements(sharding.PartitionSpec(("data", "pod")), pods)
    finally:
        dist.destroy_process_group()


def _reference_arg_bytes(arch, shape_name, multi_pod):
    """The reference's spec arithmetic: each leaf of its ``build_step``
    arguments, every dim divided, rounded up, by the product of its spec's
    mesh-axis sizes, times the leaf's item size."""
    sizes = {"pod": 2, "data": 16, "model": 16}
    _, args, in_shard, _ = j_steps.build_step(J_ARCHS[arch], j_shapes.SHAPES[shape_name],
                                              multi_pod=multi_pod)
    leaves = jax.tree.leaves(args)
    specs = jax.tree.leaves(in_shard, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(specs)
    total = 0
    for a, spec in zip(leaves, specs):
        n = 1
        for i, d in enumerate(a.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            n *= -(-d // math.prod(sizes[x] for x in axes))
        total += n * np.dtype(a.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("llama3.2-1b", "decode_32k", False),
    ("hymba-1.5b", "long_500k", True),
], ids=["llama-decode_32k-16x16", "hymba-long_500k-2x16x16"])
def test_dry_run_places_the_reference_bytes_per_device(tmp_path, arch, shape_name, multi_pod):
    """``run_one`` on a ``fake`` group of 256 or 512 ranks runs the step on
    meta tensors; its per-device argument bytes are the reference's spec
    arithmetic exactly, its record has the reference's name and keys
    (less those with no counterpart), its roofline H100 constants, and the
    group is torn down after it."""
    import torch.distributed as dist

    res = dryrun.run_one(arch, shape_name, multi_pod, tmp_path)
    assert not dist.is_initialized()
    assert res["memory"]["args_bytes_per_chip"] == _reference_arg_bytes(arch, shape_name,
                                                                        multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    assert (tmp_path / f"{arch}__{shape_name}__{mesh_name}.json").exists()
    assert res["chips"] == (512 if multi_pod else 256) and res["mesh"] == mesh_name
    assert "compile_s" not in res and "xla_cost_analysis" not in res
    hlo = res["hlo_analysis"]
    assert hlo["flops_per_chip"] > 0 and hlo["collective_op_count"] > 0
    assert hlo["collective_bytes_per_chip"] == sum(hlo["collective_breakdown"].values())
    assert res["roofline"]["compute_s"] == hlo["flops_per_chip"] / 989.4e12
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW) == (989.4e12, 3.35e12)


def test_grad_dtype_barrier_casts_the_cotangent_exactly():
    """Identity forward; the backward casts the float32 cotangent to x's
    dtype, bit for bit the reference's cast."""
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)).bfloat16()
    ct = rng.standard_normal((4, 8)).astype(np.float32)
    x = xb.clone().requires_grad_(True)
    y = common.grad_dtype_barrier(x)
    assert y.dtype == torch.bfloat16 and torch.equal(y, xb)
    (g,) = torch.autograd.grad(y.float(), x, torch.from_numpy(ct))
    assert g.dtype == torch.bfloat16
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a: jcommon.grad_dtype_barrier(a).astype(jnp.float32), jx)
    (jg,) = vjp(jnp.asarray(ct))
    assert jg.dtype == jnp.bfloat16
    assert np.array_equal(g.float().numpy(), np.asarray(jg.astype(jnp.float32)))
    x32 = torch.zeros(3, requires_grad=True)
    (g32,) = torch.autograd.grad(common.grad_dtype_barrier(x32).sum(), x32)
    assert g32.dtype == torch.float32


# ---------------------------------------------------------------------------
# build_step's steps on the SMOKE configs against the reference's
# ---------------------------------------------------------------------------


def twin(arch, **change):
    base = dataclasses.asdict(J_SMOKES[arch])
    base.update(change)
    return JConfig(**base), TConfig(**base)


def carried(jcfg, tcfg, seed, scale):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda a: a * scale if a.ndim > 1 else a, jp)
    return jp, tmodel.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def assert_logits_close(got, want, scale_w):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if scale_w == 1.0:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def assert_tree_scaled(got, want, tol, what):
    for path, w in want.items():
        g, w = got[path].float().numpy(), np.asarray(w, np.float32)
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), (what, path)


@pytest.mark.parametrize("scale_w", [1.0, 0.1], ids=["reference-init", "tamed"])
@pytest.mark.parametrize("arch,overrides", [
    ("llama3.2-1b", None),
    ("llama3.2-1b", {"attn_tp": True, "heads_tp": "model"}),
    ("hymba-1.5b", None),
], ids=["llama", "llama-attn_tp", "hymba"])
def test_prefill_and_decode_steps_equal_the_references(arch, overrides, scale_w):
    """``build_step``'s prefill step, then (without ``attn_tp``, which the
    decode does not read) 3 decode steps over the padded cache."""
    jcfg, tcfg = twin(arch)
    jp, tp = carried(jcfg, tcfg, 3, scale_w)
    b, plen, steps_n = 2, 32, 3
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, jcfg.vocab, (b, plen)).astype(np.int32)
    pshape = shapes.InputShape("p", plen, b, "prefill")
    jfn = j_steps.build_step(jcfg, j_shapes.InputShape("p", plen, b, "prefill"),
                             multi_pod=False, rule_overrides=overrides)[0]
    fn = steps.build_step(tcfg, pshape, multi_pod=False, rule_overrides=overrides)[0]
    with jax.set_mesh(j_mesh.make_host_mesh()):
        jl, jc = reference_jit.jit(jfn)(jp, {"tokens": jnp.asarray(prompt)})
    heads = []
    flash = common.blockwise_attention
    common.blockwise_attention = lambda q, k, v, **kw: heads.append(k.shape[2]) or flash(
        q, k, v, **kw)
    try:
        tl, tc = fn(tp, {"tokens": torch.from_numpy(prompt)})
    finally:
        common.blockwise_attention = flash
    assert_logits_close(tl, jl, scale_w)
    assert set(heads) == {tcfg.n_heads if overrides else tcfg.n_kv_heads}
    assert tc["global"]["k"].shape[-2] == tcfg.n_kv_heads
    if overrides:
        return
    total = plen + steps_n + 1
    jc = jmodel.pad_cache(jc, plen, total)
    tc = tmodel.pad_cache(tc, plen, total)
    dshape = shapes.InputShape("d", total, b, "decode")
    jfn = j_steps.build_step(jcfg, j_shapes.InputShape("d", total, b, "decode"),
                             multi_pod=False)[0]
    fn = steps.build_step(tcfg, dshape, multi_pod=False)[0]
    forced = rng.integers(0, jcfg.vocab, (steps_n, b)).astype(np.int32)
    with jax.set_mesh(j_mesh.make_host_mesh()):
        jstep = reference_jit.jit(jfn)
        for i in range(steps_n):
            jl, jc = jstep(jp, jc, jnp.asarray(forced[i]), jnp.int32(plen + i))
            tl, tc = fn(tp, tc, torch.from_numpy(forced[i]), plen + i)
            assert_logits_close(tl, jl, scale_w)


@pytest.mark.parametrize("scale_w", [1.0, 0.1], ids=["reference-init", "tamed"])
def test_bf16_grad_train_step_equals_the_references(scale_w):
    """One ``build_step`` train step under the ``bf16_grad`` rule on
    llama's SMOKE in bfloat16: the loss and the AdamW moments (the
    gradients, as ``m`` = 0.1·g and ``v`` = 0.05·g²), the step counter;
    the barrier's cast reaches the port's gradients (bfloat16)."""
    jcfg, tcfg = twin("llama3.2-1b", dtype="bfloat16")
    jp, tp = carried(jcfg, tcfg, 5, scale_w)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab, (4, 32)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (4, 32)).astype(np.int32)
    over = {"bf16_grad": True}
    jfn = j_steps.build_step(jcfg, j_shapes.SHAPES["train_4k"], multi_pod=False,
                             rule_overrides=over)[0]
    with jax.set_mesh(j_mesh.make_host_mesh()):
        jp1, jo1, jm = reference_jit.jit(jfn)(jp, j_adamw_init(jp, jcfg.opt_dtype),
                                             {"tokens": jnp.asarray(tokens),
                                              "labels": jnp.asarray(labels)})
    fn = steps.build_step(tcfg, shapes.SHAPES["train_4k"], multi_pod=False,
                          rule_overrides=over)[0]
    seen = []
    barrier = common.grad_dtype_barrier
    common.grad_dtype_barrier = lambda x: seen.append(x.dtype) or barrier(x)
    try:
        tp, to, tm = fn(tp, adamw_init(tp, tcfg.opt_dtype),
                        {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    finally:
        common.grad_dtype_barrier = barrier
    assert seen == [torch.bfloat16]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-3 if scale_w == 1.0 else 2e-4)
    assert int(to["step"]) == int(jo1["step"]) == 1
    for mom in ("m", "v"):
        got = t_flat(tmodel.params_to_tree(to[mom], tcfg))
        want = {p: np.asarray(v) for p, v in t_flat(jax.tree.map(np.asarray, jo1[mom])).items()}
        assert got.keys() == want.keys()
        if scale_w == 0.1:
            assert_tree_scaled(got, want, 5e-2, mom)
        elif mom == "v":
            norm = lambda d: math.sqrt(sum(float((np.asarray(v, np.float64) ** 2).sum())
                                           for v in d.values()))
            got_norm = norm({p: v.float().numpy() for p, v in got.items()})
            assert abs(got_norm - norm(want)) <= 0.2 * norm(want)
