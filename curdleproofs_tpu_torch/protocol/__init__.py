"""Protocol layer: the Curdleproofs shuffle argument, vector-first.

Every sub-argument is written against the batched `ScalarVec` / `PointVec`
value types (curdleproofs_tpu_torch.vectors) so each O(n) operation is a single
dispatch into the CUDA kernels or the native host backend, and all wire
formats come from one declarative codec (protocol.wire).

Modules:
  wire        declarative byte/JSON codec shared by every proof type
  primitives  Pedersen group commitments, the CRS, the deferred-MSM batcher
  folding     Bulletproofs-style folding arguments (IPA, same-MSM)
  products    grand-product and same-permutation arguments
  sigma       Sigma-protocols (same-scalar, tracker opening)
  shuffle     the top-level shuffle argument
  whisk       Ethereum Whisk byte-level consensus API

The public names are those of the JAX package's `models/api.py` facade.
"""
from curdleproofs_tpu_torch.protocol.folding import IPA, SameMSMProof, generate_ipa_blinders
from curdleproofs_tpu_torch.protocol.primitives import CurdleproofsCrs, GroupCommitment, MSMAccumulator
from curdleproofs_tpu_torch.protocol.products import GrandProductProof, SamePermutationProof
from curdleproofs_tpu_torch.protocol.shuffle import (
    N_BLINDERS,
    CurdleProofsProof,
    VerifierInput,
    shuffle_permute_and_commit_input,
    verify_shuffle_proofs,
)
from curdleproofs_tpu_torch.protocol.sigma import SameScalarProof, TrackerOpeningProof
from curdleproofs_tpu_torch.protocol.whisk import (
    AreValidWhiskShuffleProofs,
    AssertIsValidWhiskOpeningProof,
    AssertIsValidWhiskShuffleProof,
    BLSPubkey,
    GenerateWhiskShuffleProof,
    GenerateWhiskShuffleProofs,
    GenerateWhiskTrackerProof,
    IsValidWhiskOpeningProof,
    IsValidWhiskShuffleProof,
    WhiskShuffleProof,
    WhiskTracker,
)

__all__ = [
    "GroupCommitment",
    "CurdleproofsCrs",
    "IPA",
    "generate_ipa_blinders",
    "GrandProductProof",
    "MSMAccumulator",
    "TrackerOpeningProof",
    "SameMSMProof",
    "SamePermutationProof",
    "SameScalarProof",
    "N_BLINDERS",
    "CurdleProofsProof",
    "VerifierInput",
    "shuffle_permute_and_commit_input",
    "verify_shuffle_proofs",
    "AreValidWhiskShuffleProofs",
    "BLSPubkey",
    "GenerateWhiskShuffleProof",
    "GenerateWhiskShuffleProofs",
    "GenerateWhiskTrackerProof",
    "IsValidWhiskOpeningProof",
    "IsValidWhiskShuffleProof",
    "AssertIsValidWhiskOpeningProof",
    "AssertIsValidWhiskShuffleProof",
    "WhiskShuffleProof",
    "WhiskTracker",
]
