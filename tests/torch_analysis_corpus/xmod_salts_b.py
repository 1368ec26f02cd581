# ruff: noqa
"""Cross-module half of the RPL009 fixture: imports the salt from
``xmod_salts_a`` and collides it with a local literal. Standalone (no
ProjectIndex) the import is unresolvable and the rule stays silent;
under ``lint_paths`` the collision fires."""
from faults.spec import lane_generator

from xmod_salts_a import SHARED_SALT


def imported_lane(seed, index):
    return lane_generator(seed, index, SHARED_SALT)


def literal_lane(seed, index):
    return lane_generator(seed, index, 0xBEEF)
