def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card; skips when torch.cuda.is_available() "
        "is false")
