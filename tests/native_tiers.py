"""The `tier` fixture: a test that takes it runs once on the port's native
host-graph library and once on its numpy tier (`native.available` patched
to False, as tests/test_native.py forces the JAX package's fallback)."""

import pytest

from glnn_tpu_torch import native


@pytest.fixture(params=["native", "numpy"])
def tier(request, monkeypatch):
    if request.param == "native":
        assert native.available(), native.describe()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param
