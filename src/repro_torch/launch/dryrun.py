"""The dry run's data: which (arch, shape) pairs run, and its ``--opt``
overrides of the sharding rules (the JAX package's ``launch/dryrun.py``).

The reference's ``run_one`` lowers and compiles each step on a 256- or
512-chip XLA mesh and reads a TPU roofline from the compiled HLO
(``launch/hlo_analysis.py``); its stand-in is ROADMAP.md §1 item 15, so
this module keeps only the tables that ``build_step`` is driven with.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import LONG_CONTEXT_OK

#: ``--opt`` name -> the rule overrides it installs
OPT_OVERRIDES: Dict[str, Dict[str, object]] = {
    "attn_tp": {"attn_tp": True, "heads_tp": "model"},   # Megatron GQA-TP attention
    "kvseq": {"kv_seq": "model", "kv_heads": None,        # sequence-sharded KV decode
              "kv_head_dim": None, "decode_seq_shard": True},
    "bf16grad": {"bf16_grad": True},                      # bf16 residual-stream cotangents
    "nofsdp": {"dmodel": None},
}


def runnable(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False
    return True

