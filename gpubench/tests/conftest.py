def pytest_configure(config):
    config.addinivalue_line(
        "markers", "needs_cuda: runs on a CUDA card; skips without one")
