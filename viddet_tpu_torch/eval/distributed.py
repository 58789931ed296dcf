"""Cross-process merge of metric states for sharded evaluation
(counterpart of ``viddet_tpu/eval/distributed.py``).

Every process evaluates a disjoint strided shard of the val set
(``cli/evaluate.py``), then the metric states are all-gathered over the
job and merged into one metric before ``get()``.  The states are
variable-length pickles, so they cross through ``all_gather_object``
(JAX gathers their byte lengths, then the padded bytes).
"""

from __future__ import annotations

from typing import List

import torch.distributed as dist

from viddet_tpu_torch.parallel.mesh import process_count


def gather_states(state: dict) -> List[dict]:
    """One picklable state dict per process, in process order.  Without a
    group of several processes it is ``[state]`` (no collective), so the
    eval CLI calls it unconditionally."""
    if process_count() == 1:
        return [state]
    states: List = [None] * process_count()
    dist.all_gather_object(states, state)
    return states


def merge_metric_states(metric, states: List[dict]):
    """Rebuild ``metric`` from per-process states, in process order.  The
    metric is reset first, so the local shard (row ``process_index`` of
    ``states``) is not counted twice."""
    metric.reset()
    for state in states:
        metric.merge_state(state)
    return metric
