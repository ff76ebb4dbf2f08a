"""Test config: CPU-only, 1 visible device (the dry-run sets its own
XLA_FLAGS in a separate process; tests must NOT see 512 fake devices)."""
import os

# deterministic, quiet
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "")


def pytest_configure(config):
    # hard-watchdog marker for the concurrency suite: enforced by
    # pytest-timeout where installed (CI installs requirements-dev.txt);
    # registered here so environments without the plugin don't warn
    config.addinivalue_line(
        "markers", "timeout(seconds): abort the test after N seconds "
        "(pytest-timeout; inert when the plugin is absent)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's hand-written "
        "kernels); skips without one")
