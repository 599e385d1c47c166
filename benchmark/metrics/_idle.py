"""The device's idle share of a traced pass, in %: the traced window's
seconds with no kernel, copy or set running on the card; nothing where
the trace shows no device operation."""


def idle_pct(run):
    prof = run.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
