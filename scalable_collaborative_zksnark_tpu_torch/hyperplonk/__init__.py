"""HyperPlonk protocol layer: the local baselines, the collaborative
provers and their verifier (the JAX package's ``hyperplonk``; parity:
hyperplonk/src/{hyperplonk.rs,dhyperplonk.rs}).  The JAX package's
``dhyperplonk_phased``, a TPU compile workaround returning ``dhyperplonk``'s
bundle, has no counterpart here."""

from .collaborative import cpermcheck, dhyperplonk, dhyperplonk_data_parallel, dpermcheck
from .local import LocalInputs, local_hyperplonk, local_hyperplonkpp, local_inputs
from .params import PackedProvingParameters, packed_proving_parameters
from .verify import verify_local_hyperplonk

__all__ = [
    "LocalInputs",
    "verify_local_hyperplonk",
    "PackedProvingParameters",
    "cpermcheck",
    "dhyperplonk",
    "dhyperplonk_data_parallel",
    "dpermcheck",
    "local_hyperplonk",
    "local_hyperplonkpp",
    "local_inputs",
    "packed_proving_parameters",
]
