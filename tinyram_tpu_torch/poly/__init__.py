from .ntt import ntt, powers, powers_device, eval_poly, tree_sum, coeff_scale, omega_for
from .domain import Domain, domain_cache

__all__ = [
    "ntt",
    "powers",
    "powers_device",
    "eval_poly",
    "tree_sum",
    "coeff_scale",
    "omega_for",
    "Domain",
    "domain_cache",
]
