"""Runtime helpers: compile-cache placement, synthetic content, the trace
reduction, and the CLI's platform choice."""

import numpy as np
import pytest

from myyuv_tpu.runtime import devtrace, jaxcache, synthetic


def test_cache_dir_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert jaxcache.cache_dir() == str(tmp_path / "env")
    assert jaxcache.cache_dir(str(tmp_path / "arg")) == str(tmp_path / "env")


def test_cache_dir_default_is_checkout(monkeypatch):
    from pathlib import Path
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = Path(__file__).resolve().parent.parent
    assert jaxcache.cache_dir() == str(checkout / ".jax_cache")


def test_enable_points_jax_at_the_env_dir(monkeypatch, tmp_path):
    import jax
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        assert jaxcache.enable("ignored") == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_natural_content_is_seeded_and_natural():
    a = synthetic.natural_bgrx(64, 96, seed=3)
    assert a.shape == (64, 96, 4) and a.dtype == np.uint8
    assert (a[..., 3] == 0).all()
    np.testing.assert_array_equal(a, synthetic.natural_bgrx(64, 96, seed=3))
    assert not np.array_equal(a, synthetic.natural_bgrx(64, 96, seed=4))
    # natural statistics: neighbours correlate far more than in noise
    y = synthetic.natural_planes(64, 96, seed=3)[0].astype(np.float64)
    n = synthetic.noise_planes(64, 96, seed=3)[0].astype(np.float64)

    def corr(p):
        return np.corrcoef(p[:, :-1].ravel(), p[:, 1:].ravel())[0, 1]

    assert corr(y) > 0.8 and abs(corr(n)) < 0.2


def test_trace_summary_busy_is_the_interval_union():
    events = [("k1", 0, 10), ("k2", 5, 10), ("k1", 30, 5)]
    s = devtrace.summarize(events, reps=1, named=("k",))
    assert s["busy_ms"] == pytest.approx(20e-6)
    assert s["kernel_ms"] == {"k": pytest.approx(25e-6)}
    s2 = devtrace.summarize(events, reps=5)
    assert s2["kernel_ms"]["k1"] == pytest.approx(15e-6 / 5)
    with pytest.raises(RuntimeError, match="no GPU events"):
        devtrace.summarize([])


@pytest.mark.parametrize("platform,ok", [("gpu", True), ("cpu", True),
                                         ("metal", False)])
def test_cli_platform_choices(platform, ok):
    from myyuv_tpu import cli
    if ok:
        assert platform in cli._PLATFORMS
    else:
        with pytest.raises(SystemExit):
            cli.main(["missing.bmp", "-info", "--platform", platform])
