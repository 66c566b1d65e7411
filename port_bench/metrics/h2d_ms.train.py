"""Device ms of host-to-device copies per iteration (the loader's images)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("stage_units") or not tr["h2d_copies"]:
        return None
    return tr["h2d_ms"] / tr["stage_units"]
