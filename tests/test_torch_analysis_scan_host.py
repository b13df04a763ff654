"""Kernel K4 (``csrc/analysis_scan.cu``) runs on the CPU as a plain function.

K4 is one thread and uses nothing of the card, so g++ compiles its source
unchanged against ``tests/torch_cuda_on_host.py``'s header (the CUDA
qualifiers defined away) and the kernel runs on host memory, chunk after
chunk with both carries carried, against its plain version
(``ops/analysis_scan_cuda.py::analysis_chunk_plain``) in float64: every
event and both carries bit for bit (the source and the plain version do the
same operations in the same order, FMA contraction off).

This is the check to run on a change to K4 before the card sees it. It
skips where there is no g++.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cuda_on_host import k4_on_host, pointers  # noqa: E402,F401


def _k4_chunk(fn, pd, smoother, carry, cols):
    """One chunk through the kernel on host memory -> (smoother, carry, events)."""
    from vbt_tpu_torch.analysis.smoother_scan import SmootherCarry
    from vbt_tpu_torch.analysis.velocity_torch import EventRecord, VelocityCarry

    n = cols[0].shape[0]
    s_out = SmootherCarry(*(torch.empty_like(t) for t in smoother))
    v_out = VelocityCarry(*(torch.empty_like(t) for t in carry))
    dtypes = (torch.bool, torch.int32) + (torch.float64,) * 7
    events = EventRecord(*(torch.empty(n, dtype=d) for d in dtypes))
    fn(pointers(cols), pd.data_ptr(), n, pointers(smoother), pointers(carry),
       pointers(s_out), pointers(v_out), pointers(events))
    return s_out, v_out, events


def _fuzz_series(seed, n):
    """A noisy sinusoidal bar path (the fuzz of tests/test_velocity_jax.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 30.0
    y = 0.5 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.1, 0.6) * t) + rng.normal(0, 0.002, n)
    x = 0.4 + rng.normal(0, 0.005, n)
    nph = np.full(n, 0.16) + rng.normal(0, 0.01, n)
    npw = np.full(n, 0.28) + rng.normal(0, 0.01, n)
    return [t, x, y, np.gradient(y), nph, npw]


@pytest.mark.parametrize("chunk", [7, 64])
def test_analysis_kernel_on_host_matches_plain(k4_on_host, chunk):
    from vbt_tpu_torch.analysis.smoother_scan import initial_smoother
    from vbt_tpu_torch.analysis.velocity_torch import initial_carry
    from vbt_tpu_torch.ops.analysis_scan_cuda import analysis_chunk_plain

    series = [torch.from_numpy(np.ascontiguousarray(c)) for c in _fuzz_series(11, 200)]
    pd = torch.tensor(0.45, dtype=torch.float64)
    got = want = (initial_smoother(), initial_carry())
    fired = 0
    for i in range(0, 200, chunk):
        cols = [c[i:i + chunk].contiguous() for c in series]
        *got, got_ev = _k4_chunk(k4_on_host, pd, *got, cols)
        *want, want_ev = analysis_chunk_plain(pd, *want, cols)
        for g, w in zip(got_ev, want_ev):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        fired += int(want_ev.fired.sum())
        for g_carry, w_carry in zip(got, want):
            for g, w in zip(g_carry, w_carry):
                torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert fired >= 4  # phases ended inside the series
