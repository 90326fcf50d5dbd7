"""Step functions (train / prefill / decode) with their sharding specs.

``build_step(cfg, shape, multi_pod=...)`` returns ``(step_fn, example
args as meta tensors, in_specs, out_specs)``, the reference's
``launch/steps.py::build_step``: each step runs inside ``use_rules`` of
:func:`rules_for`, whose rules the models read (``attn_tp``,
``bf16_grad``), and the specs give every input and output its
``PartitionSpec`` under those rules (batch -> (pod, data); ff/vocab/attn
projections -> model; FSDP d_model -> data; long_500k (B=1) shards the KV
cache sequence axis over data instead of the batch).

:func:`place` puts real tensors (a model, the AdamW state, batch and
cache dicts) on a mesh by those specs as DTensors, as the reference's
``jax.jit(in_shardings=...)`` does; a step called inside
``sharding.use_mesh(mesh)`` returns its outputs redistributed to
``out_specs``.  On the 1×1 host mesh :func:`place` returns its inputs
unchanged and the steps run on plain tensors.

``train_step(params, opt_state, batch, cfg)`` is the train branch: loss
and gradients (over ``cfg.grad_accum`` micro-batches), the cosine
schedule at the optimizer's step, and AdamW.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch import sharding
from repro_torch.launch import shapes as shapes_lib
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.sharding import PartitionSpec as P


def loss_and_grads(params: model.Model, batch: Dict[str, torch.Tensor], cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss (detached) and its gradient by parameter name."""
    with params.trainable():
        named = dict(params.named_parameters())
        loss = model.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


def train_step(params: model.Model, opt_state, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig):
    """One optimizer step; ``params`` and the moments are updated in place.
    Returns ``(params, opt_state, {"loss": float32 tensor})``.

    With ``cfg.grad_accum = na > 1`` the batch splits into ``na``
    consecutive micro-batches; the loss accumulates ``loss / na`` in
    float32 and the gradients ``g / na`` in the parameters' dtype, from
    zeros, as the reference's scan does.
    """
    na = cfg.grad_accum
    if na == 1:
        loss, grads = loss_and_grads(params, batch, cfg)
    else:
        micro = {k: v.reshape((na, v.shape[0] // na) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        loss = sharding.replicated(
            torch.zeros((), dtype=torch.float32, device=params.embed.device), like=params.embed)
        grads = {k: torch.zeros_like(p) for k, p in params.named_parameters()}
        for i in range(na):
            l, g = loss_and_grads(params, {k: v[i] for k, v in micro.items()}, cfg)
            loss = loss + l / na
            for k, acc in grads.items():
                acc.add_(g[k] / na)
    lr = cosine_schedule(opt_state["step"], peak_lr=3e-4, warmup=2000, total=100_000)
    params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
    return params, opt_state, {"loss": loss}


# ---------------------------------------------------------------------------
# Rules and specs
# ---------------------------------------------------------------------------


def rules_for(cfg: ModelConfig, shape, *, multi_pod: bool, overrides=None):
    r = sharding.default_rules(
        multi_pod=multi_pod,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        model_axis=16,
        batch_shardable=shape.global_batch >= (32 if multi_pod else 16),
        shard_kv_seq=shape.global_batch == 1,
        # FSDP only in training (it amortises the optimizer state); at
        # inference weights stay TP-only, except for models whose TP-sharded
        # weights alone exceed ~12 GiB per chip (grok-1: 631 GiB bf16 / 16).
        fsdp=shape.kind == "train" or cfg.param_count() * 2 / 16 > 12e9,
    )
    r["attn_flat"] = "model"  # flattened head*dim projections always divide
    if cfg.ssm_nheads and cfg.ssm_nheads % 16 != 0:
        r["ssm_heads"] = None  # per-head scalars replicate when not divisible
    if cfg.ssm_dinner and (cfg.ssm_dinner % 16 or (cfg.ssm_dinner // 16) % cfg.ssm_headdim):
        r["ssm_inner"] = None  # shard only when shards stay head-aligned
    if overrides:
        r.update(overrides)
    return r


def _batch_sharding(cfg, shape, rules):
    """PartitionSpec per data-batch key (labels included)."""
    batch_axes = rules.get("batch")
    return {k: P(batch_axes, *([None] * (s.dim() - 1)))
            for k, s in shapes_lib.batch_specs(cfg, shape, with_labels=True).items()}


def _cache_sharding(cfg, shape, rules):
    """PartitionSpec tree of the decode cache, matched by leaf path: an
    SSD ``state`` (..., B, H, N, P), a ``conv`` history (..., B, W, C), or
    attention ``k``/``v`` (..., B, C, KV, hd)."""
    batch = rules.get("batch")
    kv_seq = rules.get("kv_seq")
    kvh = rules.get("kv_heads")
    kvd = rules.get("kv_head_dim")
    ssmh = rules.get("ssm_heads")

    def leaf_spec(keys, leaf):
        nd = leaf.dim()
        if "state" in keys:
            return P(*([None] * (nd - 4)), batch, ssmh, None, None)
        if "conv" in keys:
            return P(*([None] * (nd - 3)), batch, None, None)
        return P(*([None] * (nd - 4)), batch, kv_seq, kvh, kvd)

    def walk(t, keys):
        if isinstance(t, dict):
            return {k: walk(v, keys + (k,)) for k, v in t.items()}
        return leaf_spec(keys, t)

    return walk(shapes_lib.cache_specs(cfg, shape), ())


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def _placed(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor

    want = sharding.placements(spec, mesh)
    if sharding.is_dtensor(t):
        return t if tuple(t.placements) == want else t.redistribute(mesh.device_mesh, want)
    return distribute_tensor(t, mesh.device_mesh, want)


def _walk(arg, spec, mesh):
    if isinstance(arg, nn.Module):
        return _place_module(arg, spec, mesh)
    if isinstance(arg, dict):
        if isinstance(spec, dict) and not set(arg) <= set(spec):
            spec = model.specs_by_name(arg, spec)  # an AdamW moment keyed by parameter name
        return {k: _walk(v, spec[k], mesh) for k, v in arg.items()}
    if isinstance(arg, (tuple, list)):
        return type(arg)(_walk(a, s, mesh) for a, s in zip(arg, spec))
    if isinstance(arg, torch.Tensor):
        return _placed(arg, spec, mesh)
    return arg  # a Python int (the decode position)


def _place_module(module: nn.Module, tree, mesh) -> nn.Module:
    """Each parameter of ``module`` replaced, in place, by itself placed by
    its spec (a DTensor ``nn.Parameter``); one already so placed stays."""
    specs = model.specs_by_name(module, tree)
    for name, p in list(module.named_parameters()):
        t = _placed(p.detach(), specs[name], mesh)
        if not (sharding.is_dtensor(p) and tuple(t.placements) == tuple(p.placements)):
            owner, _, leaf = name.rpartition(".")
            module.get_submodule(owner).register_parameter(
                leaf, nn.Parameter(t, requires_grad=p.requires_grad))
    return module


def place(args, specs, mesh):
    """``args`` (a tuple, or one argument) as DTensors on ``mesh`` by
    ``specs`` (:func:`build_step`'s ``in_specs`` or ``out_specs``): plain
    tensors are distributed (``distribute_tensor``), DTensors
    redistributed; a model's parameters are replaced in place by DTensor
    parameters (:func:`model.specs_by_name`), an AdamW moment keyed by
    parameter name is placed as the parameters are; Python ints pass.
    On a mesh of one device (the host mesh) it returns ``args`` unchanged.
    A step called inside ``sharding.use_mesh`` returns its outputs so
    placed by its ``out_specs`` (a model's parameters, updated in place,
    keep theirs)."""
    if sharding.device_mesh_of(mesh) is None:
        return args
    return _walk(args, specs, mesh)


# ---------------------------------------------------------------------------
# build_step
# ---------------------------------------------------------------------------


def build_step(cfg: ModelConfig, shape, *, multi_pod: bool, rule_overrides=None):
    """Returns ``(step_fn, example_args (meta tensors), in_specs, out_specs)``.

    * train: ``step_fn(params, opt_state, batch)`` -> ``(params,
      opt_state, {"loss"})`` (:func:`train_step`, updated in place);
    * prefill: ``step_fn(params, batch)`` -> ``(logits, cache)``;
    * decode: ``step_fn(params, cache, token, pos)`` -> ``(logits,
      cache)``, one ``model.decode_step`` (the cache updated in place,
      ``pos`` an int or a 0-d tensor on the host), whose attention
      launches ``decode_attention`` on the card.

    The example arguments are meta tensors (``model.abstract_params``, the
    AdamW state of those, ``shapes.batch_specs``/``decode_specs``);
    callers pass real tensors of the same shapes and dtypes.
    """
    rules = rules_for(cfg, shape, multi_pod=multi_pod, overrides=rule_overrides)
    with sharding.use_rules(rules):
        pspecs = model.param_specs(cfg)
        pstructs = model.abstract_params(cfg)

        if shape.kind == "train":
            batch_structs = shapes_lib.batch_specs(cfg, shape, with_labels=True)
            batch_shard = _batch_sharding(cfg, shape, rules)
            opt_structs = adamw_init(pstructs, cfg.opt_dtype)
            opt_shard = {"m": pspecs, "v": pspecs, "step": P()}

            args = (pstructs, opt_structs, batch_structs)
            in_shard = (pspecs, opt_shard, batch_shard)
            out_shard = (pspecs, opt_shard, {"loss": P()})

            def train_fn(params, opt_state, batch):
                with sharding.use_rules(rules):
                    return place(train_step(params, opt_state, batch, cfg), out_shard,
                                 sharding.active_mesh())

            return train_fn, args, in_shard, out_shard

        if shape.kind == "prefill":
            batch_structs = shapes_lib.batch_specs(cfg, shape, with_labels=False)
            batch_shard = _batch_sharding(cfg, shape, rules)
            batch_shard = {k: batch_shard[k] for k in batch_structs}

            def prefill_step(params, batch):
                with sharding.use_rules(rules):
                    return place(model.prefill(params, batch, cfg), out_shard,
                                 sharding.active_mesh())

            args = (pstructs, batch_structs)
            in_shard = (pspecs, batch_shard)
            cache_shard = _cache_sharding(
                cfg,
                shapes_lib.InputShape(shape.name, shape.seq_len, shape.global_batch, "decode"),
                rules,
            )
            out_shard = (P(rules.get("batch"), rules.get("vocab")), cache_shard)
            return prefill_step, args, in_shard, out_shard

        # decode
        dec = shapes_lib.decode_specs(cfg, shape)
        cache_shard = _cache_sharding(cfg, shape, rules)
        tok_shard = P(rules.get("batch"))

        args = (pstructs, dec["cache"], dec["token"], dec["pos"])
        in_shard = (pspecs, cache_shard, tok_shard, P())
        out_shard = (P(rules.get("batch"), rules.get("vocab")), cache_shard)

        def serve_step(params, cache, token, pos):
            with sharding.use_rules(rules):
                return place(model.decode_step(params, cache, token, int(pos), cfg), out_shard,
                             sharding.active_mesh())

        return serve_step, args, in_shard, out_shard
