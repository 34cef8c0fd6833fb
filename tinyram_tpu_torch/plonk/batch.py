"""Batch proof verification with a single accumulated IPA MSM.

Port of `tinyram_tpu/plonk/batch.py`.  Each proof's IPA check is the
linear relation ⟨g_i, G⟩ + Σ (s·P) == 0 (see ipa.verify_open_deferred).
N relations hold together (w.h.p.) iff one random combination
Σ ρ_i·rel_i == 0 holds, so N proofs cost the cheap host checks plus one
size-n MSM on the SRS's device instead of N of them.

The ρ_i come from `rng.randbelow` (the `secrets` module by default), as
the prover's blinds do.  `finalize_detailed` verifies proof by proof.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field

import numpy as np

from ..field.field import FP
from ..ipa import SRS
from ..ipa.ipa import check_deferred
from .keygen import VerifyingKey
from .verifier import _verify, verify_proof

P = FP.modulus


@dataclass
class BatchVerifier:
    items: list = field(default_factory=list)

    def add_proof(self, instances: list, proof: bytes) -> None:
        self.items.append((instances, proof))

    def finalize(self, srs: SRS, vk: VerifyingKey, rng=secrets) -> bool:
        """True iff every queued proof verifies (one combined MSM)."""
        deferred: list = []
        for inst, proof in self.items:
            try:
                if not _verify(srs, vk, inst, proof, defer=deferred):
                    return False
            except (ValueError, AssertionError):
                return False
        if not deferred:
            return True
        combined_g = np.zeros(srs.n, dtype=object)
        combined_terms: list = []
        for g_scalars, terms in deferred:
            rho = rng.randbelow(P - 1) + 1
            combined_g = (combined_g + rho * np.asarray(g_scalars, dtype=object)) % P
            combined_terms.extend((rho * sc % P, pt) for sc, pt in terms)
        return check_deferred(srs, combined_g, combined_terms)

    def finalize_detailed(self, srs: SRS, vk: VerifyingKey) -> list[bool]:
        """Per-proof verdicts."""
        return [
            verify_proof(srs, vk, inst, proof) for inst, proof in self.items
        ]
