import os

# IMPORTANT: do NOT set XLA_FLAGS / device-count overrides here — smoke tests
# and benches must see the real single-device CPU.  Multi-device semantics are
# tested in subprocesses (tests/test_distributed.py) and the production mesh
# only inside launch/dryrun.py.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

try:
    from hypothesis import settings
except ImportError:  # pragma: no cover — property tests skip themselves
    settings = None

if settings is not None:
    settings.register_profile("repro", deadline=None, max_examples=25,
                              derandomize=True)
    settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skips without one")
