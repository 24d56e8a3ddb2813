"""collective_ms (ms an encode; layer parallel: parallel/collectives.py,
knn.py, kmeans.py over NCCL): device time in rank 0's trace in operations
whose name holds ``nccl``, over the traced window's encodes. An NCCL
kernel runs from its launch until every rank has joined, so this holds
the ranks' waits for one another as well as the transfers."""


def read(run):
    if run.trace is None or not run.encodes:
        return None
    s, n = run.trace.seconds_matching("nccl")
    return 1e3 * s / len(run.encodes) if n else None
