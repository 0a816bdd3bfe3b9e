"""The paper's HNSW index (``repro_torch.core.hnsw``, numpy on the host)
against the JAX package's ``repro.core.hnsw`` on the CPU: for one seed the
same levels, links, entry point and search results, bit for bit; and the
reference's own checks (``tests/test_index_and_policy.py::TestHNSW``) on
the port."""
import numpy as np
import pytest

from repro.core.hnsw import HNSWIndex as JHNSWIndex
from repro_torch.core import HNSWIndex


def _vectors(n, d, seed):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    return vecs, rng


@pytest.mark.parametrize("n,d,m,ef_c,max_elements,seed", [
    (300, 32, 8, 64, 512, 0),
    (200, 48, 4, 32, 64, 3),      # resizes twice while it builds
])
def test_graph_and_search_equal_reference(n, d, m, ef_c, max_elements, seed):
    vecs, rng = _vectors(n, d, seed)
    kw = dict(dim=d, max_elements=max_elements, m=m, ef_construction=ef_c,
              ef_search=48, seed=seed)
    ours, ref = HNSWIndex(**kw), JHNSWIndex(**kw)
    for v in vecs:
        assert ours.add(v) == ref.add(v)
    assert ours.levels == ref.levels
    assert ours.links == ref.links
    assert ours.entry_point == ref.entry_point
    assert ours.count == ref.count and ours.max_elements == ref.max_elements
    np.testing.assert_array_equal(ours.vectors, ref.vectors)
    queries = vecs[:40] + 0.05 * rng.normal(size=(40, d)).astype(np.float32)
    for k in (1, 5):
        for q in queries[:10]:
            for a, b in zip(ours.search(q, k), ref.search(q, k)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(ours.search_batch(queries, k),
                        ref.search_batch(queries, k)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_exact_on_small_sets():
    """High recall against brute force (the reference's bar, 0.9)."""
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(400, 32)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    idx = HNSWIndex(dim=32, max_elements=512, m=8, ef_construction=64,
                    ef_search=48, seed=0)
    for v in vecs:
        idx.add(v)
    queries = vecs[:50] + 0.02 * rng.normal(size=(50, 32)).astype(np.float32)
    gt = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ vecs.T
    ids, _ = idx.search_batch(queries, k=1)
    recall = float(np.mean(ids[:, 0] == np.argmax(gt, axis=1)))
    assert recall >= 0.9, f"HNSW recall {recall}"


def test_dynamic_resize():
    idx = HNSWIndex(dim=8, max_elements=4, m=4, seed=0)
    rng = np.random.default_rng(1)
    for _ in range(10):    # beyond initial max_elements
        idx.add(rng.normal(size=8).astype(np.float32))
    assert idx.count == 10
    assert idx.max_elements >= 10


def test_empty_search():
    idx = HNSWIndex(dim=8)
    ids, sims = idx.search(np.ones(8, dtype=np.float32), k=2)
    assert (ids == -1).all()
    assert np.isneginf(sims).all()
