from .srs import SRS, setup
from .ipa import commit, commit_many, open_poly, verify_open

__all__ = ["SRS", "setup", "commit", "commit_many", "open_poly", "verify_open"]
