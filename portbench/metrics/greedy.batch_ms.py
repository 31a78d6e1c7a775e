"""greedy.batch_ms: greedy.batch, the port's spans around each call of
the greedy batch (ops/greedy_batch.py: K1, the rescue, K2r and the host
engine, with their uploads and copies back), summed a window job (host
clock)."""

from portbench.program_spans import ms_per_job


def read(run):
    return ms_per_job(run, "greedy.batch")
