def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the PyTorch port's CUDA kernels); "
                   "skipped where torch.cuda.is_available() is false")
