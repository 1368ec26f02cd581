# ruff: noqa
"""Cross-module half of the RPL009 fixture: the shared salt constant
lives here (linted with ``lint_paths`` together with ``xmod_salts_b``;
not part of the rpl*_bad/_good marker globs)."""
from faults.spec import lane_generator

SHARED_SALT = 0xBEEF


def owner_lane(seed, index):
    return lane_generator(seed, index, SHARED_SALT)
