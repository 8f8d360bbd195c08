"""Time two host-looped paths of the port on the card, for one package tree.

Usage, from the repository root on a machine with an NVIDIA GPU:

    python3 microbench/host_paths.py <tree>

``<tree>`` is a directory holding ``pgvectorscale_tpu_torch`` (the
repository root, or an unpacked ``git archive`` of another commit, so two
commits can be compared in one run: parent, change, change, parent).  It
builds a plain-storage index and an SBQ index of the first 30,000 rows of
the seeded "cohere" corpus, then prints one JSON line: the best of 4
walls of a 1,024-query plain-storage search (L=100, rescore 50; its beam
loop runs from the host), and the wall, visits and microseconds a visit
of one streamed query pulling 1,500 rows through ``search_iter``.
"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
from pgvectorscale_tpu_torch.config import StorageLayout
from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus
v, q = synthetic_corpus("cohere", 30000, 1024, seed=0)
v = np.ascontiguousarray(v)
out = {"tree": sys.argv[1]}
p = DiskannIndex.build(v, IndexConfig(num_dimensions=768, storage_layout=StorageLayout.PLAIN))
qd = torch.as_tensor(q).cuda()
secs = []
for _ in range(4):
    torch.cuda.synchronize(); t = time.perf_counter()
    p.search(qd, 10, QueryParams(search_list_size=100, rescore=50)); torch.cuda.synchronize()
    secs.append(time.perf_counter() - t)
out["plain_search_s"] = min(secs)
s = DiskannIndex.build(v, IndexConfig(num_dimensions=768))
it = s.search_iter(q[0], QueryParams(search_list_size=100, rescore=50))
t = time.perf_counter()
it.next_batch(1500)
torch.cuda.synchronize()
out["iter_1500_rows_s"] = time.perf_counter() - t
out["visits"] = it.total_visits
out["us_per_visit"] = out["iter_1500_rows_s"] / max(out["visits"], 1) * 1e6
print(json.dumps(out), flush=True)
