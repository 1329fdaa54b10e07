"""On the card only: one short run of each cell through gpubench/run.py, as
the benchmark's check runs it. Skips without a CUDA card; on the card:
python -m pytest gpubench/tests/test_gpubench_card.py -m cuda -q"""

import json
import os
import subprocess
import sys

import pytest
import torch

from gpubench.tests.tiny import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["video.ide3d-ffhq512", "video.ide3d-ffhq512-pkl",
                                      "train.ide3d-ffhq512", "painter.ide3d-ffhq512"])
def test_a_short_run_on_the_card_is_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "gpubench", "run.py"), "--workload",
                           workload, "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
