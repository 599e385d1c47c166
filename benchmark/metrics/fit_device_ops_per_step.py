"""``fit_device_ops_per_step``: device operations (kernels, copies and
sets) per traced fit step, counted in the profiler's trace; nothing
where it shows none."""


def read(run):
    prof = run.get("profile")
    if not prof or not prof["device_ops"]:
        return None
    return prof["device_ops"] / run["profiled_steps"]
