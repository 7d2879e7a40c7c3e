"""The environment names both packages read, held still around a test.

``PIO_PROFILE_DIR``, ``PIO_COMPILE_CACHE_DIR``, ``PIO_COMPILE_CACHE``,
``PIO_UPDATE_URL``, ``PIO_FS_BASEDIR``, ``PIO_BIN_CHUNK_MB`` and
``PIO_TRANSFER_DOUBLE_BUFFER`` are read by the JAX package too (its
mesh, train, deploy, eval, engine server and ALS put), and one xdist
worker runs many test files in turn: a value a port test leaves set
would make a later JAX train capture a profile or point JAX's compile
cache at a deleted directory. Tests set them with ``monkeypatch`` only;
``shared_env_unchanged``, autouse wherever it is imported, fails a
test that leaves any of them other than it found them.
"""

from __future__ import annotations

import os

import pytest

SHARED_ENV = ("PIO_PROFILE_DIR", "PIO_COMPILE_CACHE_DIR",
              "PIO_COMPILE_CACHE", "PIO_UPDATE_URL", "PIO_FS_BASEDIR",
              "PIO_BIN_CHUNK_MB", "PIO_TRANSFER_DOUBLE_BUFFER")


@pytest.fixture(autouse=True)
def shared_env_unchanged():
    before = {name: os.environ.get(name) for name in SHARED_ENV}
    yield
    after = {name: os.environ.get(name) for name in SHARED_ENV}
    assert after == before, f"shared environment changed: {before} -> {after}"
