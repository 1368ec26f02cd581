# ruff: noqa
"""RPL009 firing: two reserved-lane constants sharing one value, plus a
literal colliding with a named salt: the lanes are the SAME stream."""
from faults.spec import lane_generator

_SALT_DROP = 0x51A7
_SALT_CORRUPT = 0x51A7


def drop_lane(seed, index):
    return lane_generator(seed, index, _SALT_DROP)


def corrupt_lane(seed, index):
    return lane_generator(seed, index, _SALT_CORRUPT)  # expect: RPL009


def telemetry_lane(seed, index):
    return lane_generator(seed, index, salt=0x51A7)  # expect: RPL009
