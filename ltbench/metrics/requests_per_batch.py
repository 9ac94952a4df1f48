"""requests_per_batch: mean of the window's entries of BatchScheduler.batch_sizes."""

from ltbench.stats import window_entries


def read(run):
    sizes = window_entries(run, "batch_sizes", "batches_run")
    return None if not sizes else sum(sizes) / len(sizes)
