"""feature_rows_per_batch: window deltas of FeatureCoalescer.requests_run over batches_run."""

from ltbench.stats import delta


def read(run):
    req, bat = delta(run, "feature_requests_run"), delta(run, "feature_batches_run")
    return None if not bat else req / bat
