"""The whole-name check for JAX and the JAX package, and the plain
reference's independence from the program."""

import subprocess
import sys

from zkbench import harness
from zkbench.tests.conftest import REPO


def test_whole_top_level_names_only():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "scalable_collaborative_zksnark_tpu", "scalable_collaborative_zksnark_tpu.fields.fr",
             "scalable_collaborative_zksnark_tpu_torch", "scalable_collaborative_zksnark_tpu_torch.bench",
             "jaxtyping", "flaxen", "numpy.jax", "torch"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "scalable_collaborative_zksnark_tpu",
        "scalable_collaborative_zksnark_tpu.fields.fr"]


def test_the_port_passes():
    assert harness.forbidden_modules(["scalable_collaborative_zksnark_tpu_torch",
                                      "scalable_collaborative_zksnark_tpu_torch.hyperplonk"]) == []


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] "
                          "for m in sys.modules}))"], cwd=REPO, capture_output=True, text=True,
                         check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))  # noqa: S307


def test_reference_imports_no_program_and_no_jax():
    loaded = _loaded_after("import zkbench.reference.dhyperplonk_leader, zkbench.reference.srs, "
                           "zkbench.reference.g1, zkbench.compare, zkbench.traffic, zkbench.roofline")
    assert not loaded & {"jax", "jaxlib", "flax", "scalable_collaborative_zksnark_tpu",
                         "scalable_collaborative_zksnark_tpu_torch"}


def test_harness_and_adapter_load_no_jax():
    loaded = _loaded_after("import zkbench.run, zkbench.harness, zkbench.tracing, "
                           "zkbench.adapters.dhyperplonk_leader")
    assert "scalable_collaborative_zksnark_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "scalable_collaborative_zksnark_tpu"}
