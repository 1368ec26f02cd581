# ruff: noqa
"""Pragma accounting: valid suppression, reason-less, stale."""
import torch


def routed(x):
    # repro: allow[RPL001] corpus case: pragma on the line above, with reason
    if torch.cuda.device_count() > 1:
        return "multi"
    return "single"


def routed_same_line(x):
    if torch.cuda.device_count() > 1:  # repro: allow[RPL001] same-line pragma
        return "multi"
    return "single"


def unexcused(x):
    # repro: allow[RPL001]
    if torch.cuda.device_count() > 1:  # expect: RPL001
        return "multi"
    return "single"


# repro: allow[RPL003] nothing fires RPL003 here, so this pragma is stale
WIDTH = 128


def documented(x):
    """Documentation QUOTING the convention is not a pragma:

        # repro: allow[RPL001] quoted in a docstring, must not count

    Only real comment tokens suppress or consume the --strict budget:
    the RPL001 on the next line must stay active.
    """
    if torch.cuda.device_count() > 1:  # expect: RPL001
        return "multi"
    return "single"


QUOTED = "# repro: allow[RPL001] quoted in a string literal, must not count"
