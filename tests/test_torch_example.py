"""``examples/train_classifier_torch.py`` on the CPU, in one process and
under ``torchrun`` with two gloo ranks, at a small image size: it exits 0,
logs finite losses as JSON lines, leaves a checkpoint of its last step and,
in one process, a serving artifact that loads and runs.  No JAX."""

import json
import math
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "examples" / "train_classifier_torch.py"
ARGS = ["--steps", "3", "--batch", "4", "--image-size", "32", "--num-classes", "10", "--cpu",
        "--log-every", "1"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("model, ranks", [("vit", 1), ("cait", 2)])
def test_example_trains_checkpoints_and_exports(tmp_path, model, ranks):
    launch = [sys.executable, str(EXAMPLE)] if ranks == 1 else [
        sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={ranks}",
        "--master_addr=127.0.0.1", f"--master_port={_free_port()}", str(EXAMPLE)]
    artifact = tmp_path / "model.pt2"
    extra = ["--export", str(artifact)] if ranks == 1 else []
    proc = subprocess.run([*launch, "--model", model, *ARGS, "--ckpt-dir",
                           str(tmp_path / "ckpt"), *extra], cwd=REPO, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert [line["step"] for line in lines] == [1, 2, 3]
    assert all(math.isfinite(line["loss"]) for line in lines)
    assert f"processes={ranks}" in proc.stdout and proc.stdout.rstrip().endswith("done")
    assert [p.name for p in (tmp_path / "ckpt").iterdir()] == ["checkpoint_3.pt"]
    if ranks == 1:
        from vit_tpu_torch.interop.export import load_forward_file

        with torch.no_grad():
            out = load_forward_file(str(artifact))(torch.randn(4, 32, 32, 3))
        assert out.shape == (4, 10) and bool(torch.isfinite(out).all())
