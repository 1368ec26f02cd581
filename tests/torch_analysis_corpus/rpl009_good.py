# ruff: noqa
"""RPL009 non-firing: one distinct salt per reserved lane; a data-
dependent salt carries no literal to collide on and is skipped, never
guessed at."""
from faults.spec import lane_generator

_SALT_DROP = 0x0FA1
_SALT_CORRUPT = 0x0FA2


def drop_lane(seed, index):
    return lane_generator(seed, index, _SALT_DROP)


def corrupt_lane(seed, index):
    return lane_generator(seed, index, _SALT_CORRUPT)


def client_lane(seed, index, client_id):
    return lane_generator(seed, index, client_id)
