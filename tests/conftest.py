def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (the port's Hopper kernels); "
        "skips with its reason where none is visible")
