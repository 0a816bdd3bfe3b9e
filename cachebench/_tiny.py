"""A cell small enough for the CPU tests: the harness's whole run (the
port's engine, scheduler and model on the CPU, in f32) at toy sizes."""
from __future__ import annotations

import time

import torch

from cachebench import harness, workload

LIMITS = {"cache_mismatch": 0, "answer_mismatch": 0, "unanswered": 0,
          "score_err": 1e-5, "logit_gap": 1e-3, "token_mismatch": 0.02}


def cell(arch: str = "dense", capacity_factor: float = 1.25,
         **traffic) -> harness.Cell:
    model = {"name": "tiny", "arch_type": arch, "n_layers": 2,
             "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 64,
             "d_ff": 128, "vocab": 512, "dtype": "float32",
             "vocab_pad_multiple": 128}
    if arch == "moe":
        model.update(n_experts=4, moe_topk=2,
                     capacity_factor=capacity_factor)
    deploy = {"dim": 384, "capacity": 1024, "value_len": 48,
              "threshold": 0.8, "batch": 16, "max_prompt_len": 16,
              "max_new_tokens": 6}
    t = dict(workload.load_traffic("paper_mix"), corpus_per_category=40,
             lead_in_s=0.3, warmup=[{"rows": 16, "paraphrase_ratio": 0.0}])
    t.update(traffic)
    spec = {"rate_qps": 60.0,
            "model_check": {"batches": 2},
            "limits": dict(LIMITS)}
    return harness.Cell("tiny", spec, {"model": model, "deploy": deploy}, t,
                        [])


def run(c: harness.Cell, seed: int = 2**31 + 3, seconds: float = 1.0,
        **kw) -> dict:
    return harness.run(c, seed=seed, seconds=seconds, trace=False,
                       device=torch.device("cpu"),
                       t_start=time.perf_counter(), log=lambda s: None, **kw)


def correct(c: harness.Cell, out: dict) -> bool:
    return all(out["checks"][k] <= v for k, v in c.cell["limits"].items())
