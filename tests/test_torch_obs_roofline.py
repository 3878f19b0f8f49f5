"""repro_torch.obs histograms and repro_torch.launch.roofline against the
JAX package's: the same observations give the same buckets, count, sum,
percentiles and snapshot entry; every peak row, cost model and achieved
fraction is the reference's, and the h100 row holds the H100's peaks."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402


def _observations():
    rng = np.random.default_rng(0)
    vals = list(rng.exponential(20.0, 200))
    # on bucket bounds, past the last bound, and at zero
    return vals + [0.05, 1.0, 1.0, 2.5, 10000.0, 12345.0, 0.0, -1.0]


@pytest.mark.parametrize("buckets", [None, (1.0, 2.0, 4.0),
                                     metrics.SIZE_BUCKETS])
def test_histogram_matches_the_reference(buckets):
    kw = {} if buckets is None else {"buckets": buckets}
    h = metrics.Histogram("lat", **kw)
    jh = jmetrics.Histogram("lat", **kw)
    for v in _observations():
        h.observe(v)
        jh.observe(v)
    assert h.buckets == jh.buckets
    assert h.count == jh.count and h.sum == jh.sum
    for p in (0.0, 1.0, 25.0, 50.0, 90.0, 99.0, 99.9, 100.0):
        assert h.percentile(p) == jh.percentile(p)
    assert h.to_dict() == jh.to_dict()


def test_histogram_edges_match_the_reference():
    assert metrics.LATENCY_BUCKETS_MS == jmetrics.LATENCY_BUCKETS_MS
    assert metrics.SIZE_BUCKETS == jmetrics.SIZE_BUCKETS
    for mod in (metrics, jmetrics):
        empty = mod.Histogram("e")
        assert empty.percentile(50.0) == 0.0
        d = empty.to_dict()
        assert d["count"] == 0 and d["min"] == 0.0 and d["max"] == 0.0
        with pytest.raises(ValueError, match="ascending"):
            mod.Histogram("bad", buckets=(2.0, 1.0))
        with pytest.raises(ValueError, match="bucket"):
            mod.Histogram("bad", buckets=())
        with pytest.raises(ValueError, match="percentile"):
            empty.percentile(101.0)
    assert metrics.Histogram("e").to_dict() == jmetrics.Histogram(
        "e").to_dict()


def test_registry_histograms_and_snapshot_schema():
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for r in (reg, jreg):
        r.counter("c", tier="engine").add(3)
        r.gauge("g").set(2.5)
        h = r.histogram("serve.latency_ms", tenant="a")
        assert r.histogram("serve.latency_ms", tenant="a") is h
        for v in (0.3, 7.0, 7.0, 600.0):
            h.observe(v)
        r.histogram("sizes", buckets=(1, 4, 16)).observe(5)
        with pytest.raises(ValueError, match="already registered"):
            r.histogram("sizes", buckets=(1, 2))
        with pytest.raises(TypeError):
            r.counter("g")
    assert reg.snapshot() == jreg.snapshot()
    assert reg.snapshot()["histograms"]["serve.latency_ms{tenant=a}"][
        "p99"] == 1000.0


def test_obs_histogram_is_a_noop_while_off():
    obs.reset()
    jobs.reset()
    try:
        h = obs.histogram("x")
        h.observe(3.0)
        assert h.count == 0 and h.percentile(50) == 0.0
        assert obs.snapshot()["histograms"] == {}
        obs.enable()
        jobs.enable()
        for mod in (obs, jobs):
            mod.histogram("x", buckets=(1.0, 10.0), k="v").observe(3.0)
            mod.histogram("x", k="v").observe(30.0)
        assert obs.snapshot()["histograms"] == jobs.snapshot()["histograms"]
        assert obs.snapshot()["histograms"]["x{k=v}"]["count"] == 2
    finally:
        obs.reset()
        jobs.reset()


@pytest.mark.parametrize("kind", ["tpu", "gpu", "cpu", "unknown",
                                  "no-such-device"])
def test_peak_rows_match_the_reference(kind):
    assert roofline.peaks_for(kind) == jroof.peaks_for(kind)


def test_h100_row_and_detection():
    row = roofline.HW_PEAKS["h100"]
    assert row["peak_flops_bf16"] == 989e12
    assert row["peak_flops_f32"] == 67e12
    assert row["hbm_bytes_per_s"] == 3.35e12
    assert row["ici_bytes_per_s"] == 450e9
    assert row["hbm_bytes"] == 80 * 2**30
    assert roofline.peaks_for("h100") is row
    want = "cpu"
    if torch.cuda.is_available():
        want = ("h100" if "H100" in torch.cuda.get_device_name()
                else "gpu")
    assert roofline.peaks_for(None) is roofline.HW_PEAKS[want]
    assert roofline.peaks_for() is roofline.HW_PEAKS[want]
    for k in ("tpu", "gpu", "cpu", "unknown"):
        assert roofline.HW_PEAKS[k] == jroof.HW_PEAKS[k]


SHAPES = {
    "coverage_matvec": dict(theta=16384, n=334863),
    "fused_select": dict(theta=16384, n=334863),
    "ic_frontier_step": dict(B=256, n=3997),
    "arena_commit": dict(B=256, n=334863, kind="packed"),
    "packed_count": dict(theta=16384, n=334863),
    "token_count": dict(theta=16384, n=334863, s_pad=65536),
    "sample_write_count": dict(B=256, n=4099, steps=7),
}


@pytest.mark.parametrize("kernel", sorted(SHAPES))
def test_kernel_costs_and_achieved_fractions_match(kernel):
    assert sorted(roofline.KERNEL_COST_MODELS) == sorted(
        jroof.KERNEL_COST_MODELS)
    shape = SHAPES[kernel]
    assert roofline.kernel_cost(kernel, **shape) == jroof.kernel_cost(
        kernel, **shape)
    for kind in ("tpu", "gpu", "cpu", "unknown"):
        for wall in (0.0, 1e-6, 1e-3, 1.0):
            assert roofline.achieved_frac(
                kernel, wall, device_kind=kind, **shape) == \
                jroof.achieved_frac(kernel, wall, device_kind=kind, **shape)
    with pytest.raises(KeyError):
        roofline.kernel_cost("no_such_kernel", n=1)


def test_roofline_terms_match_the_reference():
    args = (3.2e12, 4.1e9, 2.5e8, 1.1e13, 4)
    for hw in (None, "gpu", "h100"):
        if hw is None:
            got, want = (roofline.roofline_terms(*args),
                         jroof.roofline_terms(*args))
        else:
            got = roofline.roofline_terms(*args, hw=roofline.peaks_for(hw),
                                          extra={"cell": hw})
            want = jroof.roofline_terms(*args, hw=roofline.peaks_for(hw),
                                        extra={"cell": hw})
        assert got == want
    zero = roofline.roofline_terms(0.0, 0.0, 0.0, 0.0, 1)
    assert zero == jroof.roofline_terms(0.0, 0.0, 0.0, 0.0, 1)
    assert math.isclose(
        roofline.roofline_terms(989e12, 0.0, 0.0, 989e12, 1,
                                hw=roofline.HW_PEAKS["h100"])["bound_s"],
        1.0)
