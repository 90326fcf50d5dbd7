"""Batched serving engine over a MIG-scheduled cluster.

The engine closes the paper's loop end to end: tenant requests arrive with
a MIG profile demand; :class:`AdmissionController` (MFI or a baseline
policy) places or rejects them on the simulated A100 fleet; admitted
requests run real model steps — a shared batched prefill followed by
token-by-token decode with a common cache (keys and values, whose
attention is the hand-written ``decode_attention`` CUDA kernel on the
card, and with the ssm and hybrid families the SSD state and conv
history) — and completion releases the MIG slices.

Batching model: requests are served in waves of up to ``num_slots`` (one
shared position counter per wave; prompts within a wave have equal
lengths).  The port's copy of the JAX package's engine, with the same
wave, release, flush and drain rules; it runs eagerly where the reference
jits its two model steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.serving.admission import AdmissionController


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                 # (S,) int32 — equal S within a wave
    max_new_tokens: int
    profile: str = "1g.10gb"           # MIG demand of the tenant workload
    tenant: str = "default"
    priority: int = 0                  # 0 = most urgent
    patience: int = 0                  # waves it may queue before final reject
    output: Optional[List[int]] = None
    admitted: bool = False
    rejected: bool = False
    finished: bool = False


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        num_slots: int = 4,
        max_len: int = 256,
        num_gpus: int = 4,
        policy: str = "mfi",
        device=None,
    ):
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(
                f"params lie on {params.embed.device}, the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.admission = AdmissionController(num_gpus, policy=policy)
        self._decode = lambda p, c, t, pos: model.decode_step(p, c, t, pos, cfg)
        self._prefill = lambda p, b: model.prefill(p, b, cfg)

    def fail_gpu(self, gpu_id: int) -> List[int]:
        """Inject a GPU failure: evicted workloads re-queue in the admission
        controller with backoff and re-admit (onto surviving GPUs, or the
        failed one after :meth:`recover_gpu`) as capacity allows.  Returns
        the evicted workload ids."""
        return self.admission.fail_gpu(gpu_id)

    def recover_gpu(self, gpu_id: int) -> None:
        """Bring a previously failed GPU back into placement."""
        self.admission.recover_gpu(gpu_id)

    def _release(self, req: Request) -> None:
        # an evicted request's slices are already gone — finishing its
        # service then is not an error, just nothing left to release
        if req.request_id in self.admission.placements:
            self.admission.release(req.request_id)

    def _serve_wave(self, wave: List[Request]) -> None:
        """Prefill + decode one wave of admitted requests together."""
        n = len(wave)
        plen = len(wave[0].prompt)
        if any(len(r.prompt) != plen for r in wave):
            raise ValueError("wave prompts must align")
        prompts = torch.as_tensor(np.stack([r.prompt for r in wave]), dtype=torch.int32,
                                  device=self.device)

        logits, cache = self._prefill(self.params, {"tokens": prompts})
        cache = model.pad_cache(cache, plen, self.max_len)
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        for r in wave:
            r.output = []

        alive = list(range(n))
        for i in list(alive):  # zero-token requests finish at prefill
            if wave[i].max_new_tokens <= 0:
                wave[i].finished = True
                self._release(wave[i])
                alive.remove(i)
        if not alive:
            return
        max_new = max(wave[i].max_new_tokens for i in alive)
        for step in range(min(max_new, self.max_len - plen - 1)):
            host = tokens.tolist()  # the wave's tokens, read once per step
            for i in list(alive):
                wave[i].output.append(host[i])
                if len(wave[i].output) >= wave[i].max_new_tokens:
                    wave[i].finished = True
                    self._release(wave[i])
                    alive.remove(i)
            if not alive:
                break
            logits, cache = self._decode(self.params, cache, tokens, plen + step)
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        for i in alive:  # hit max_len
            wave[i].finished = True
            self._release(wave[i])

    def run(self, requests: List[Request]) -> Dict:
        """Serve the request list in admission-controlled waves.

        Each request submits with its ``(tenant, priority, patience)``;
        the MIG scheduler admits it, parks it in the controller's waiting
        queue (``patience > 0``), or finally rejects it.  Releases at wave
        completion re-drive admission, so parked requests join later waves
        in queue order; the controller clock ticks once per iteration and
        expires entries past their patience.  Every terminal request ends
        with ``output`` as a list (``[]`` when rejected or expired) and
        ``finished=True``.
        """
        pending = list(requests)
        by_id = {r.request_id: r for r in pending}
        ready: List[Request] = []  # admitted, awaiting a wave slot
        waves = 0
        while pending or ready or self.admission.queue_depth:
            while pending and len(ready) < self.num_slots:
                req = pending.pop(0)
                placement = self.admission.submit(
                    req.request_id,
                    req.profile,
                    tenant=req.tenant,
                    priority=req.priority,
                    patience=req.patience,
                )
                if placement is not None:
                    req.admitted = True
                    ready.append(req)
                elif not self.admission.in_queue(req.request_id):
                    req.rejected = True
                    req.finished = True
                    req.output = []
            wave = ready[: self.num_slots]
            ready = ready[len(wave):]
            if wave:
                # wave boundary: waiting requests age one tick BEFORE the
                # wave's releases re-drive admission, so their recorded
                # wait counts the wave they sat out
                self.admission.tick()
                self._serve_wave(wave)  # releases re-drive queue admission
                waves += 1
            elif not pending and not ready:
                # no running work will ever free capacity — flush the queue
                self.admission.flush_queue()
            else:
                self.admission.tick()
            for placement in self.admission.drain_dispatched():
                req = by_id.get(placement.workload_id)
                if req is None or req.finished:  # e.g. a re-admitted eviction
                    continue
                req.admitted = True
                ready.append(req)
            for wid in self.admission.drain_expired():
                req = by_id.get(wid)
                if req is None or req.finished:
                    continue
                req.rejected = True
                req.finished = True
                req.output = []
        return {"waves": waves, **self.admission.stats()}
