"""A run with its timed path broken underneath comes out not correct, for
each fault a serving cell can have (there is no exchange between chips
on one card), and the controls fail the limits that sound runs pass."""
import dataclasses
import random

import pytest

from cachebench import _tiny, harness, workload

pytest.importorskip("repro_torch.serving.engine")
from repro_torch.models.model import Model  # noqa: E402


@pytest.fixture(autouse=True)
def _repeats(monkeypatch):
    """A third of each stream asks an earlier query of it again, verbatim,
    so that an insert that was lost shows as a miss where a hit is due."""
    build = workload.build_stream

    def with_repeats(*args, **kwargs):
        stream = build(*args, **kwargs)
        qs, rng = stream.queries, random.Random(7)
        for i in rng.sample(range(1, len(qs)), len(qs) // 3):
            qs[i] = qs[rng.randrange(i)]
        return stream
    monkeypatch.setattr(workload, "build_stream", with_repeats)


def _cell():
    return _tiny.cell("dense")


def test_sound_run_is_correct():
    c = _cell()
    assert _tiny.correct(c, _tiny.run(c))


def test_step_that_keeps_its_state(monkeypatch):
    def frozen(self, runtime, *a, peeked, valid, **k):
        # the peek's decision, and the slab, counters and ring as they were
        result = dataclasses.replace(peeked, hit=peeked.hit & valid)
        self.last_index = result.index
        return result, runtime
    monkeypatch.setattr(harness._StepRecorder, "step", frozen)
    c = _cell()
    out = _tiny.run(c)
    assert out["checks"]["cache_mismatch"] > 0
    assert not _tiny.correct(c, out)


def test_half_the_batch_left_out(monkeypatch):
    serve = harness.CachedEngine.serve_batch

    def half(self, batch, **kw):
        out = serve(self, batch, **kw)
        h = (len(out) + 1) // 2
        return out[:h] + [out[i % h] for i in range(h, len(out))]
    monkeypatch.setattr(harness.CachedEngine, "serve_batch", half)
    c = _cell()
    out = _tiny.run(c)
    assert out["checks"]["cache_mismatch"] + \
        out["checks"]["answer_mismatch"] > 0
    assert not _tiny.correct(c, out)


def test_token_altered_where_produced(monkeypatch):
    step = Model.decode_step

    def altered(self, caches, tokens):
        logits, caches = step(self, caches, tokens)
        logits = logits.clone()
        logits[0, 0, 9] = logits[0, 0].max() + 10.0   # row 0 picks token 9
        return logits, caches
    monkeypatch.setattr(Model, "decode_step", altered)
    c = _cell()
    out = _tiny.run(c)
    assert out["checks"]["logit_gap"] > c.cell["limits"]["logit_gap"]
    assert not _tiny.correct(c, out)


def test_answer_altered_where_produced(monkeypatch):
    serve = harness.CachedEngine.serve_batch

    def altered(self, batch, **kw):
        out = serve(self, batch, **kw)
        return [dataclasses.replace(out[0], answer=out[0].answer + " !")] \
            + out[1:]
    monkeypatch.setattr(harness.CachedEngine, "serve_batch", altered)
    c = _cell()
    out = _tiny.run(c)
    assert out["checks"]["answer_mismatch"] > 0
    assert not _tiny.correct(c, out)


def test_controls_fail_the_limits():
    """The reference a precision below in the program's place: TF32
    scores for the f32 keys, float8 products for the model."""
    c = _cell()
    out = _tiny.run(c, control=True)
    low = out["info"]["control"]
    lim = c.cell["limits"]
    assert low["score_err"] > lim["score_err"]
    assert low["logit_gap"] > lim["logit_gap"]
    assert low["token_mismatch"] > lim["token_mismatch"]
    assert out["checks"]["score_err"] <= lim["score_err"]
