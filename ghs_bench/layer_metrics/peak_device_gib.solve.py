"""Peak device memory the system allocated in the window, GiB."""


def read(record):
    return record.memory_peak_bytes / 2**30 if record.memory_peak_bytes else None
