"""The traffic generator: deterministic from ``--seed``, the stated
category and paraphrase mix, the same work in another order for another
seed, and a frozen copy that still equals the port's generators."""
import collections
import random

import pytest

from cachebench import workload

TRAFFIC = workload.load_traffic("paper_mix")


@pytest.fixture(scope="module")
def corpus():
    return workload.build_corpus(60, seed=TRAFFIC["corpus_seed"])


def _stream(corpus, seed, rate=50.0, seconds=4.0):
    return workload.build_stream(TRAFFIC, corpus, rate, seconds, seed)


def test_same_seed_same_inputs(corpus):
    a, b = _stream(corpus, 2**31 + 11), _stream(corpus, 2**31 + 11)
    assert a.queries == b.queries and a.due == b.due
    assert a.warmup == b.warmup


def test_other_seed_same_work_other_order(corpus):
    a, b = _stream(corpus, 5), _stream(corpus, 2**33 + 5)
    assert a.queries != b.queries
    assert sorted(map(repr, a.queries)) == sorted(map(repr, b.queries))
    gaps = [sorted(round(t - s, 12) for s, t in zip([0.0] + x.due[:-1],
                                                    x.due)) for x in (a, b)]
    assert gaps[0] == gaps[1]


def test_mix_as_stated(corpus):
    s = _stream(corpus, 123)
    n = len(s.queries)
    assert n == 50 * (TRAFFIC["lead_in_s"] + 4.0)
    cats = collections.Counter(q.category for q in s.queries)
    assert set(cats) == set(workload.CATEGORIES)
    assert max(cats.values()) - min(cats.values()) <= 1
    para = sum(q.source_id >= 0 for q in s.queries)
    assert para == round(n * TRAFFIC["paraphrase_ratio"])
    assert all(0 < d <= TRAFFIC["lead_in_s"] + 4.0 for d in s.due)
    assert s.due == sorted(s.due)
    assert [len(w) for w in s.warmup] == [w["rows"]
                                         for w in TRAFFIC["warmup"]]
    assert not any(q.source_id >= 0 for q in s.warmup[0])


def test_frozen_copy_equals_the_port():
    qa = pytest.importorskip("repro_torch.data.qa_dataset")
    ours = workload.build_corpus(60, seed=0)
    theirs = qa.build_corpus(60, seed=0)
    assert [(p.qa_id, p.category, p.question, p.answer, p.semantic_key)
            for p in ours] == [(p.qa_id, p.category, p.question, p.answer,
                                p.semantic_key) for p in theirs]
    for seed in range(20):
        q = ours[seed].question
        assert workload.paraphrase(q, random.Random(seed), 0.6) == \
            qa.paraphrase(q, random.Random(seed), 0.6)
    assert TRAFFIC["strength"] == qa._CATEGORY_STRENGTH
