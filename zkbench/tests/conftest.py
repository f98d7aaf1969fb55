"""The benchmark's own tests (run by hand: ``python -m pytest zkbench/tests``).

``tiny_root`` is a checkout-like folder with a one-cell BENCHMARK.json
for a leader of an 8-server committee (l = 1) proving 2^4 gates, the
size at which the harness runs end to end on the CPU through its
test-only path (``harness.run(..., device="cpu")``).
"""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY_CELL = "tiny.n4"


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


def make_root(dest: Path, n: int = 4, l: int = 1) -> Path:
    """A folder with BENCHMARK.json and ``zkbench/`` data files for one
    tiny cell named TINY_CELL, beside copies of the real metric readers."""
    z = dest / "zkbench"
    (z / "configs").mkdir(parents=True)
    (z / "traffic").mkdir()
    shutil.copytree(REPO / "zkbench" / "metrics", z / "metrics")
    cfg = json.loads((REPO / "zkbench" / "configs" / "dhp-leader-l8.json").read_text())
    cfg.update(name="tiny-l1", l=l, N=8 * l, t=l - 1)
    (z / "configs" / "tiny-l1.json").write_text(json.dumps(cfg))
    (z / "traffic" / f"closed-n{n}.json").write_text(json.dumps(
        {"gates_log2": n, "loop": "closed", "in_flight": 1,
         "fresh": ["V", "a_evals", "b_evals", "c_evals"]}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="tiny-l1",
                             file="zkbench/configs/tiny-l1.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name=TINY_CELL, config="tiny-l1",
                               traffic=f"closed-n{n}")]
    for m in bench["per_layer"]:
        m["workloads"] = [TINY_CELL]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
