"""The most device memory the allocator held during the window (peak
statistics reset at its start), GiB."""


def read(rec):
    if rec.kind != "train" or rec.peak_window_bytes <= 0:
        return None
    return rec.peak_window_bytes / 2 ** 30
