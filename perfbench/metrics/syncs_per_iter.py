"""Host synchronizations and device-to-host reads per iteration: the
host's `*Synchronize` calls plus the card's device-to-host copies."""

from perfbench.readers import per_iter


def read(w):
    syncs = sum(e["name"].endswith("Synchronize") for e in w.host)
    reads = sum(e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]
                for e in w.device)
    return per_iter(syncs + reads, w)
