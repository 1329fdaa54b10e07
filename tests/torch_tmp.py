"""A fixture for the port's CPU tests that write large files (snapshots of
the CLIs' full-width discriminator, weight files, datasets) under tmp_path.

pytest keeps every test's tmp_path of its last three runs; these files come
to ~5 GB a run of the port's tests, so three runs can fill a small disk. A
module that imports the fixture gets it (autouse applies where the fixture is
visible): each test's tmp_path is removed when the test ends."""

import shutil

import pytest


@pytest.fixture(autouse=True)
def drop_tmp_path(request):
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)
