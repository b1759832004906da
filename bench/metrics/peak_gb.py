"""Device memory allocated at the peak of the window
(``torch.cuda.max_memory_allocated``): a layout's own bytes show here."""


def read(r):
    return r.peak_window_bytes / 1e9 if r.peak_window_bytes else None
