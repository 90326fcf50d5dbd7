"""Multi-device placement on the CPU: four ``gloo`` processes.

One ``torch.multiprocessing`` spawn of four ranks runs every case and
hands the results back to the test process; each test reads its case.
The ranks build their meshes with ``launch.mesh.make_mesh(...,
device="cpu")``, place ``build_step``'s arguments with ``steps.place``
and call the steps inside ``sharding.use_mesh``, so every
``sharding.constraint`` redistributes DTensors and the attention and the
SSD scan run on each rank's shards (``local_map``).  Rank 0 also runs the
same step on plain tensors (the one-process port run), from the same
parameters and inputs, and the results are held to it.

Cases, on SMOKE configurations in float32 at the reference's initialiser:

* on a (2, 2) ``("data", "model")`` mesh, ``llama3.2-1b`` and
  ``hymba-1.5b``: a prefill of 16 rows × 32 tokens (the batch split over
  ``data``, heads, ff, vocab and SSD heads over ``model``), two decode
  steps from its padded cache, and one train step (the ``train_4k``
  rules: FSDP over ``data``); after the step the parameters and the AdamW
  moments keep their ``out_specs`` placements;
* a ``long_500k``-style decode of hymba at B = 1, whose cache is split
  along its slots over ``data`` (``kv_seq``): the new keys land on the
  rank that owns the slot, and the attention gathers the slots;
* on a (2, 2, 1) ``("pod", "data", "model")`` mesh under ``multi_pod``:
  a batch of 16 rows placed by the ``train_4k`` batch spec ``(("pod",
  "data"), None)`` leaves rank ``(pod, data)`` with rows ``[4·(2·pod +
  data), +4)`` (pod-major), and llama's loss on it equals the
  one-process loss;
* a plain tensor reaching ``constraint`` on the mesh raises ``TypeError``.

Tolerances are ``tests/test_torch_launch.py``'s two regimes: under the
reference's initialiser logits within 1e-4 + 1e-4 of their largest
magnitude, the loss at rtol 1e-3 and the moments ``m`` and ``v`` per leaf
at 5e-2 of the leaf's largest magnitude; with llama's weight matrices
scaled by 0.1, logits within 1e-5 of their largest magnitude.  A split
contraction sums in another order, so a mesh run is not bit-equal to the
one-process run; measured on the CPU here: logits ≤ 2.2e-4 (llama's
first decode step, 8.5e-5 of the scale: the initialiser's
ill-conditioning; prefill ≤ 2.7e-6), ≤ 1.4e-6 of the scale tamed; the
loss ≤ 1e-7 relative; the moments ≤ 1.8e-4 of a leaf's scale.
"""

import datetime
import os
import signal
import socket
import tempfile
import traceback

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
B, PROMPT, DECODE_STEPS = 16, 32, 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _err(got, want) -> float:
    return float((_full(got).float() - want.float()).abs().max())


def _params(cfg, seed, scale):
    from repro_torch.models import model

    p = model.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    if scale != 1.0:
        with torch.no_grad():
            for leaf in p.parameters():
                if leaf.dim() > 1:
                    leaf.mul_(scale)
    return p


def _serve_case(arch, m, rank, batch, scale=1.0):
    """Prefill, then DECODE_STEPS decode steps, on the mesh and (rank 0)
    on plain tensors, the weight matrices scaled by ``scale``; returns the
    logits' errors and scales."""
    from repro_torch import sharding
    from repro_torch.configs import SMOKES
    from repro_torch.launch import shapes, steps
    from repro_torch.models import model

    cfg = SMOKES[arch]
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, cfg.vocab, (batch, PROMPT), generator=gen, dtype=torch.int32)
    forced = torch.randint(0, cfg.vocab, (DECODE_STEPS, batch), generator=gen,
                           dtype=torch.int32)
    plain, params = _params(cfg, 3, scale), _params(cfg, 3, scale)
    out = {"prefill": [], "decode": [], "cache_placements": None}

    fn, _, ins, _ = steps.build_step(cfg, shapes.InputShape("p", PROMPT, batch, "prefill"),
                                     multi_pod=False)
    args = steps.place((params, {"tokens": prompt}), ins, m)
    with sharding.use_mesh(m):
        logits, cache = fn(*args)
    want, ref_cache = fn(plain, {"tokens": prompt}) if rank == 0 else (None, None)
    got = _full(logits)
    if rank == 0:
        out["prefill"].append((_err(got, want), float(want.abs().max())))

    total = PROMPT + DECODE_STEPS + 1
    fn, _, ins, _ = steps.build_step(cfg, shapes.InputShape("d", total, batch, "decode"),
                                     multi_pod=False)
    cache = {k: {n: _full(t) for n, t in v.items()} for k, v in cache.items()}
    cache = steps.place(model.pad_cache(cache, PROMPT, total), ins[1], m)
    if rank == 0:
        ref_cache = model.pad_cache(ref_cache, PROMPT, total)
    for i in range(DECODE_STEPS):
        tok = steps.place(forced[i], ins[2], m)
        with sharding.use_mesh(m):
            logits, cache = fn(params, cache, tok, PROMPT + i)
        got = _full(logits)
        if rank == 0:
            want, ref_cache = fn(plain, ref_cache, forced[i], PROMPT + i)
            out["decode"].append((_err(got, want), float(want.abs().max())))
    out["cache_placements"] = {f"{k}/{n}": tuple(t.placements) for k, v in cache.items()
                               for n, t in v.items()}
    out["cache_specs"] = {f"{k}/{n}": sharding.placements(ins[1][k][n], m)
                          for k, v in cache.items() for n in v}
    return out


def _train_case(arch, m, rank):
    """One ``train_4k``-rules step on a batch of B rows, on the mesh and
    (rank 0) on plain tensors."""
    from repro_torch import sharding
    from repro_torch.configs import SMOKES
    from repro_torch.launch import shapes, steps
    from repro_torch.models import model
    from repro_torch.optim import adamw_init

    cfg = SMOKES[arch]
    gen = torch.Generator().manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                                     dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                                     dtype=torch.int32)}
    fn, _, ins, outs = steps.build_step(cfg, shapes.SHAPES["train_4k"], multi_pod=False)
    params = model.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    placed = steps.place((params, adamw_init(params), batch), ins, m)
    out = {}
    with sharding.use_mesh(m):
        params, opt, metrics = fn(*placed)
    loss = float(_full(metrics["loss"]))
    moments = {mom: {k: _full(v) for k, v in opt[mom].items()} for mom in ("m", "v")}
    specs = model.specs_by_name(params, outs[0])
    out["placements_kept"] = all(
        tuple(t.placements) == sharding.placements(specs[k], m)
        for k, t in [*params.named_parameters(), *opt["m"].items(), *opt["v"].items()])
    if rank == 0:
        plain = model.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
        _, ref_opt, ref_metrics = fn(plain, adamw_init(plain), batch)
        out["loss"] = (loss, float(ref_metrics["loss"]))
        out["moments"] = {
            mom: max(_err(moments[mom][k], w) / max(float(w.abs().max()), 1e-30)
                     for k, w in ref_opt[mom].items())
            for mom in ("m", "v")}
    return out


def _cases(rank):
    from repro_torch import sharding
    from repro_torch.launch import mesh as meshlib

    m = meshlib.make_mesh((2, 2), ("data", "model"), device="cpu")
    res = {}
    for arch in ("llama3.2-1b", "hymba-1.5b"):
        res[("serve", arch)] = _serve_case(arch, m, rank, B)
        res[("train", arch)] = _train_case(arch, m, rank)
    res[("serve-b1", "hymba-1.5b")] = _serve_case("hymba-1.5b", m, rank, 1)
    res[("serve-tamed", "llama3.2-1b")] = _serve_case("llama3.2-1b", m, rank, B, scale=0.1)
    with sharding.use_rules(sharding.default_rules()), sharding.use_mesh(m):
        try:
            sharding.constraint(torch.zeros(2, 3), "batch", None)
            res["plain"] = None
        except TypeError as e:
            res["plain"] = str(e)
    pods = meshlib.make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    res["multi-pod"] = _multi_pod_case(pods, rank)
    return res


def _multi_pod_case(m, rank):
    """llama's ``train_4k`` batch of B rows placed on the (pod, data,
    model) mesh under ``multi_pod`` (every rank's rows and mesh
    coordinate), and the loss of the rules' forward on it, on the mesh
    and (rank 0) on plain tensors.  The forward alone: DTensor's sharding
    propagation on a three-dim mesh makes a train step cost ~18 s here."""
    from repro_torch import sharding
    from repro_torch.configs import SMOKES
    from repro_torch.launch import shapes, steps
    from repro_torch.models import model

    cfg = SMOKES["llama3.2-1b"]
    gen = torch.Generator().manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                                     dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                                     dtype=torch.int32)}
    shape = shapes.SHAPES["train_4k"]
    _, _, ins, _ = steps.build_step(cfg, shape, multi_pod=True)
    rules = steps.rules_for(cfg, shape, multi_pod=True)
    params = model.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    placed, placed_batch = steps.place((params, batch), (ins[0], ins[2]), m)
    rows = [None] * WORLD
    dist.all_gather_object(rows, (tuple(m.device_mesh.get_coordinate()),
                                  placed_batch["tokens"].to_local().clone()))
    with sharding.use_rules(rules), sharding.use_mesh(m):
        loss = float(_full(model.loss_fn(placed, placed_batch, cfg)))
    out = {"rows": rows, "spec": ins[2]["tokens"]}
    if rank == 0:
        plain = model.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
        with sharding.use_rules(rules):
            out["loss"] = (loss, float(model.loss_fn(plain, batch, cfg)))
    return out


def _worker(rank, port, path):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    signal.alarm(240)  # a rank left waiting on a failed peer ends
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        res = _cases(rank)
    except Exception:
        res = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    if rank == 0 or "error" in res:
        torch.save(res, f"{path}.{rank}")


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "results")
        mp.spawn(_worker, args=(_free_port(), path), nprocs=WORLD)
        for rank in range(WORLD):
            if os.path.exists(f"{path}.{rank}"):
                res = torch.load(f"{path}.{rank}", weights_only=False)
                assert "error" not in res, f"rank {rank}:\n{res['error']}"
        return torch.load(f"{path}.0", weights_only=False)


ARCHS = ["llama3.2-1b", "hymba-1.5b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_the_mesh_equals_one_process(results, arch):
    (err, scale), = results[("serve", arch)]["prefill"]
    assert err <= 1e-4 + 1e-4 * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_the_mesh_equals_one_process(results, arch):
    case = results[("serve", arch)]
    assert len(case["decode"]) == DECODE_STEPS
    for err, scale in case["decode"]:
        assert err <= 1e-4 + 1e-4 * scale
    assert case["cache_placements"] == case["cache_specs"]


def test_decode_with_tamed_weights_equals_one_process(results):
    """The tight regime: the weight matrices scaled by 0.1, logits within
    1e-5 of their largest magnitude."""
    case = results[("serve-tamed", "llama3.2-1b")]
    for err, scale in case["prefill"] + case["decode"]:
        assert err <= 1e-5 * scale


def test_b1_decode_with_the_cache_split_along_its_slots(results):
    from torch.distributed.tensor import Shard

    case = results[("serve-b1", "hymba-1.5b")]
    for err, scale in case["prefill"] + case["decode"]:
        assert err <= 1e-4 + 1e-4 * scale
    # kv_seq on "data" (mesh dim 0): the slots axis (2) of every k/v leaf is split
    kv = {p: pl for p, pl in case["cache_placements"].items() if p.endswith(("/k", "/v"))}
    assert kv and all(pl[0] == Shard(2) for pl in kv.values())
    assert case["cache_placements"] == case["cache_specs"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_the_mesh_equals_one_process(results, arch):
    case = results[("train", arch)]
    loss, want = case["loss"]
    assert abs(loss - want) <= 1e-3 * abs(want)
    assert case["moments"]["m"] <= 5e-2 and case["moments"]["v"] <= 5e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_and_moments_keep_their_placements(results, arch):
    assert results[("train", arch)]["placements_kept"]


def test_multi_pod_batch_splits_pod_major(results):
    case = results["multi-pod"]
    assert case["spec"] == (("pod", "data"), None)
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, 512, (B, PROMPT), generator=gen, dtype=torch.int32)
    assert sorted(c for c, _ in case["rows"]) == [(p, d, 0) for p in (0, 1) for d in (0, 1)]
    for (pod, data, _), rows in case["rows"]:
        lo = 4 * (2 * pod + data)
        assert torch.equal(rows, tokens[lo:lo + 4])
    loss, want = case["loss"]
    assert abs(loss - want) <= 1e-3 * abs(want)


def test_a_plain_tensor_on_the_mesh_raises(results):
    assert results["plain"] is not None
    assert "test_torch_mesh.py" in results["plain"] and "steps.place" in results["plain"]
