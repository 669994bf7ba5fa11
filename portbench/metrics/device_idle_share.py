"""device_idle_share: the share of the traced window (first traced epoch's
start to the last one's end) in which no operation ran on the device, from
the union of the device operations' intervals, in %. Layer: device (H100)."""


def read(record):
    t = record["trace"]
    if t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
