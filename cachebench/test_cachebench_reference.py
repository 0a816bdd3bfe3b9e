"""The references agree with the port's CPU path at a reduced size: the
frozen embedder and tokenizer equal the port's, and a whole run of the
harness on the CPU (f32, so the program and the reference compute alike)
is judged correct with every check at or near zero."""
import numpy as np
import pytest
import torch

from cachebench import _tiny, refcache, refmodel

TEXTS = ["how do i sort a list in python", "Why my router keeps "
         "disconnecting?", "", "what's the return policy for the laptop, "
         "thanks", "the  5ghz band   is very slow"]


def test_frozen_embedder_and_tokenizer_equal_the_port():
    he = pytest.importorskip("repro_torch.embedding.hash_embedder")
    tk = pytest.importorskip("repro_torch.data.tokenizer")
    assert np.array_equal(refcache.Embedder(384).embed_batch(TEXTS),
                          he.HashEmbedder(384).embed_batch(TEXTS))
    ours, theirs = refcache.Tokenizer(999), tk.HashTokenizer(999)
    a = ours.encode_batch(TEXTS, 12)
    b, _ = theirs.encode_batch(TEXTS, 12)
    assert np.array_equal(a, b)
    assert [ours.decode(r) for r in a] == [theirs.decode(r) for r in b]


#: (arch, capacity factor): experts that drop tokens past 1.25, and
#: dropless at experts / top-k, as grok-1's cell runs them
ARCHS = pytest.mark.parametrize("arch,cf", [("dense", 1.25), ("moe", 1.25),
                                            ("moe", 2.0)],
                                ids=["dense", "moe", "moe-dropless"])


@ARCHS
def test_teacher_logits_equal_the_ports_decode(arch, cf):
    """At f32 the reference's logits where each token was chosen equal
    the port's prefill-then-decode logits."""
    mm = pytest.importorskip("repro_torch.models.model")
    cb = pytest.importorskip("repro_torch.configs.base")
    from cachebench import weights
    c = _tiny.cell(arch, capacity_factor=cf)
    mc = c.config["model"]
    model = mm.Model(cb.ModelConfig(**mc), device="cpu")
    model.load_state_dict(dict(weights.make(mc, 7, "cpu")))
    torch.manual_seed(0)
    prompts = torch.randint(8, mc["vocab"], (5, 16))
    with torch.inference_mode():
        logits, caches = model(prompts, collect_cache=True, cache_size=30)
        rows = [logits[:, -1:]]
        nt = logits[:, -1:].argmax(-1)
        toks = [nt]
        for _ in range(5):
            dl, caches = model.decode_step(caches, nt)
            rows.append(dl)
            nt = dl.argmax(-1)
            toks.append(nt)
    served = torch.cat(toks, 1)
    got = torch.cat(rows, 1)
    ref = refmodel.teacher_logits(refmodel.Weights(mc, 7, "cpu"), mc,
                                  prompts, served)
    assert torch.allclose(ref, got.float(), atol=1e-4)
    assert float(refmodel.gaps(ref, served).max()) < 1e-4


@ARCHS
def test_a_whole_cpu_run_is_correct(arch, cf):
    c = _tiny.cell(arch, capacity_factor=cf)
    out = _tiny.run(c)
    ch = out["checks"]
    assert ch["cache_mismatch"] == 0 and ch["answer_mismatch"] == 0
    assert ch["unanswered"] == 0 and ch["score_err"] < 1e-5
    assert ch["gap_tokens"] > 0 and ch["token_mismatch"] == 0
    assert _tiny.correct(c, out)
    m = out["metrics"]
    assert m["resp_p95_ms"] >= m["resp_p50_ms"] > 0
    assert m["answered_qps"] > 0 and m["setup_s"] > 0


def test_result_line_gives_each_metric_its_value_and_unit():
    """The line of a ``--trace 0`` run: the cell's end-to-end metrics,
    each with its value and BENCHMARK.json's unit, and the checks last."""
    import json
    from pathlib import Path
    from cachebench import run as runpy
    c = _tiny.cell("dense")
    out = _tiny.run(c)
    bench = json.loads((Path(runpy.ROOT) / "BENCHMARK.json").read_text())
    line = runpy.result_line(out, c, bench, trace=False, kind="cpu",
                             count=1)
    assert list(line)[-1] == "checks" and line["correct"]
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(json.loads(json.dumps(line)))


def test_a_cell_prints_only_its_own_end_to_end_metrics():
    """A cell whose tails are per-layer metrics (``resp_p50_ms.qps``) has
    none of them in its ``--trace 0`` metrics."""
    import dataclasses
    c = dataclasses.replace(_tiny.cell("dense"),
                            end_to_end=("answered_qps", "setup_s"))
    out = _tiny.run(c)
    assert set(out["metrics"]) == {"answered_qps", "setup_s"}
    assert _tiny.correct(c, out)
