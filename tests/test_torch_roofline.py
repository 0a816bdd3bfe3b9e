"""The roofline terms (``repro_torch.launch.roofline``) and the dry run's
cache sizes (``repro_torch.launch.sharding``) against the JAX package's
``repro.launch.roofline`` and ``repro.launch.sharding`` on every one of
the 10 archs x 4 shapes; the port's peaks are the H100's."""
import dataclasses

import pytest

from repro.configs import ARCHITECTURES as JARCHS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.launch import roofline as jroof
from repro.launch.sharding import decode_cache_size as jcache_size
from repro.models.model import Model as JModel
from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES
from repro_torch.launch import roofline
from repro_torch.launch.sharding import decode_cache_size

REL = 1e-12
PAIRS = [(a, s) for a in ARCHITECTURES for s in INPUT_SHAPES]


def test_archs_and_shapes_are_the_references():
    assert list(ARCHITECTURES) == list(JARCHS)
    assert list(INPUT_SHAPES) == list(JSHAPES)
    assert len(PAIRS) == 40


@pytest.mark.parametrize("arch", list(ARCHITECTURES))
def test_window_list_equals_reference(arch):
    assert roofline.window_list(ARCHITECTURES[arch]) \
        == JModel(JARCHS[arch])._window_list()


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_analytic_terms_equal_reference(arch, shape):
    c, s = ARCHITECTURES[arch], INPUT_SHAPES[shape]
    jc, js = JARCHS[arch], JSHAPES[shape]
    assert dataclasses.asdict(s) == dataclasses.asdict(js)
    size = decode_cache_size(c, s)
    assert size == jcache_size(jc, js)
    csize = size if s.kind == "decode" else None
    assert roofline.tokens_processed(s.kind, s.global_batch, s.seq_len) \
        == jroof.tokens_processed(js.kind, js.global_batch, js.seq_len)
    for train in (False, True):
        assert roofline.model_flops(c.active_param_count(), 1000, train) \
            == jroof.model_flops(jc.active_param_count(), 1000, train)
    assert roofline.analytic_flops(c, s, cache_size=csize) == pytest.approx(
        jroof.analytic_flops(jc, js, cache_size=csize), rel=REL)
    for n_dp, n_mp, kv_bytes in ((1, 1, 2), (1, 1, 1), (32, 16, 2)):
        assert roofline.analytic_hbm_bytes_per_chip(
            c, s, n_dp, n_mp, cache_size=csize, kv_bytes=kv_bytes) \
            == pytest.approx(jroof.analytic_hbm_bytes_per_chip(
                jc, js, n_dp, n_mp, cache_size=csize, kv_bytes=kv_bytes),
                rel=REL)


def test_derive_uses_h100_peaks():
    assert roofline.PEAK_FLOPS == roofline.PEAK_BF16_FLOPS == 989e12
    assert roofline.PEAK_TF32_FLOPS == 494.7e12
    assert roofline.PEAK_F32_FLOPS == 67e12
    assert roofline.PEAK_BYTES == 3.35e12
    assert roofline.LINK_BW == 450e9
    kw = dict(flops=989e12, bytes_accessed=6.7e12,
              collective_bytes_per_chip=450e9, n_active_params=10,
              global_batch=2, seq_len=8)
    one = roofline.derive("a", "s", "train", "one_card", 1, **kw)
    assert (one.compute_s, one.memory_s, one.collective_s) == (1.0, 2.0, 0.0)
    assert one.dominant == "memory"
    assert one.model_gflops == 6 * 10 * 16 / 1e9
    four = roofline.derive("a", "s", "prefill", "four", 4, **kw)
    assert (four.compute_s, four.memory_s, four.collective_s) \
        == (0.25, 0.5, 1.0)
    assert four.dominant == "collective"
    assert set(one.row()) == set(jroof.derive(
        "a", "s", "train", "m", 1, **kw).row())
