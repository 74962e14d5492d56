"""The device memory the window allocated at its peak above the resident
tables, in MiB: ``torch.cuda.max_memory_allocated()`` after
``reset_peak_memory_stats()`` at the window's start, less what was
allocated once the tables were uploaded, before the entry was built and
warmed up.  So what the decoder keeps between requests (a cache built in
warm-up) counts, as does each request's working memory."""


def read(w):
    if w.peak_bytes is None:
        return None
    return (w.peak_bytes - w.base_bytes) / 2**20
