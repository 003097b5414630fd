def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card and nvcc; skips elsewhere (run: python -m pytest -m cuda)",
    )
