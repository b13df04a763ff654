"""Device idle share of the track cell's traced window (torch.profiler)."""
from benchmark.core.readings import device_idle_pct as read  # noqa: F401
