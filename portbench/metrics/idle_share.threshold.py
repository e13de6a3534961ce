"""The card's idle share over the traced decryptions: 1 - (union of the device
operations' intervals, from the profile of the card's activity alone) /
(the host clock over the same decryptions made untraced just before), in
percent. The profiler's own work lengthens a traced window (by some 20-45 %
in these launch-bound cells), not the card's busy time."""


def read(ctx):
    t = ctx["trace"]
    if not t.device:
        return None
    return 100 * (1 - t.busy_us / 1e6 / ctx["untraced_s"])
