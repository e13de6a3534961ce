"""Device-busy ms a decryption: the union of the device operations'
intervals over the traced window (contraction, inverse NTT and decode;
overlapping operations count once), divided by the decryptions traced."""


def read(ctx):
    t = ctx["trace"]
    if not t.device or not t.requests:
        return None
    return t.busy_us / 1e3 / t.requests
