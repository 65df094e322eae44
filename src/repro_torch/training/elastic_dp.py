"""Deterministic elastic data parallelism: the executable form of the
StragglerMonitor's "drop the host and elastically restore" advice (the JAX
package's training/elastic_dp.py on tensors).

A single process simulates an N-host DP fleet the way the data pipeline
tests simulate ranks: every host owns a slice of the global batch and a
replicated copy of the parameters. The two elastic properties the migration
lifecycle needs are true *by construction* here:

  * topology-invariant compute — each example runs the SAME single-example
    program (train_loop.make_per_example_step_fns), and the gradient
    "all-reduce" folds per-example grads in global example order. Any
    partitioning of the same global batch over any host count produces
    bit-identical updates on the CPU (this is what lets
    tests/test_torch_migration.py demand bit-identity across a 4-host ->
    2-host migration, not just tolerance). On a card that also needs
    ``torch.use_deterministic_algorithms(True)`` (embedding backward sums
    with atomics);

  * cursor elasticity — iterators are global-step addressed, so re-slicing
    the same global batch over a different host count replays the exact
    global token stream.

The state is updated in place, as by the port's train step."""
from __future__ import annotations

import torch

from repro_torch.data import DataIterator
from repro_torch.models.params import tree_leaves
from repro_torch.training.train_loop import (init_train_state,
                                             make_per_example_step_fns)


def fleet_topology(hosts: int, *, devices_per_host: int = 1) -> dict:
    """Migration-manifest topology record for a simulated DP fleet."""
    return {"axes": [["data", hosts]], "dp_degree": hosts,
            "device_count": hosts * devices_per_host, "host_count": hosts}


class ElasticDPTrainer:
    """N simulated hosts, replicated params, deterministic aggregation.

    The per-host iterators are real DataIterators with (dp_rank, dp_size)
    = (r, hosts); `hosts` can differ between the dumping and the resuming
    incarnation as long as the global batch divides. ``device`` is where
    the state lives and the steps run ("cuda" by default)."""

    def __init__(self, lm, opt_cfg, ds, *, global_batch: int, seq_len: int,
                 hosts: int = 1, state=None, data_step: int = 0,
                 seed: int = 0, device="cuda"):
        assert global_batch % hosts == 0, (global_batch, hosts)
        self.lm = lm
        self.opt_cfg = opt_cfg
        self.ds = ds
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.hosts = hosts
        self.grad_fn, self.apply_fn = make_per_example_step_fns(lm, opt_cfg)
        self.state = state if state is not None else init_train_state(
            lm, torch.Generator().manual_seed(seed), device=device)
        self.device = self.state["step"].device
        self.iters = [DataIterator(ds, global_batch=global_batch,
                                   seq_len=seq_len, dp_rank=r, dp_size=hosts,
                                   step=data_step) for r in range(hosts)]

    @classmethod
    def from_resume(cls, lm, opt_cfg, ds, report, *, seq_len: int,
                    hosts: int | None = None):
        """Continue a migrated run: state from the image (already placed on
        the resume's device), cursors remapped onto the (possibly different)
        host count the resume planned."""
        hosts = hosts or report.dp_degree
        return cls(lm, opt_cfg, ds, global_batch=report.data["global_batch"],
                   seq_len=seq_len, hosts=hosts, state=report.state,
                   data_step=report.data["step"])

    # ---------------------------------------------------------------- step
    def step(self) -> dict:
        """One synchronous global step. Host rank-major, local index-minor
        collection IS global example order (rank r owns examples
        [r*local, (r+1)*local)), so the fold order never depends on the
        host count."""
        per_host = [it.next() for it in self.iters]   # each [local, S+1]
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        grads_sum = None
        for batch in per_host:                        # rank order
            toks = torch.from_numpy(batch).to(self.device)
            for i in range(batch.shape[0]):           # local order
                loss, g = self.grad_fn(self.state["params"], toks[i])
                loss_sum = loss_sum + loss
                if grads_sum is None:
                    grads_sum = g
                    continue
                for a, b in zip(tree_leaves(grads_sum), tree_leaves(g)):
                    a.add_(b)
        self.state, metrics = self.apply_fn(
            self.state, grads_sum, loss_sum,
            torch.tensor(float(self.global_batch), device=self.device))
        return {k: float(v) for k, v in metrics.items()}

    def run(self, steps: int) -> dict:
        m: dict = {}
        for _ in range(steps):
            m = self.step()
        return m

    # ----------------------------------------------------------- lifecycle
    @property
    def step_count(self) -> int:
        return int(self.state["step"])

    def data_state(self) -> dict:
        """All ranks advance in lockstep; rank 0's cursor is the fleet's."""
        return self.iters[0].state()

    def topology(self) -> dict:
        return fleet_topology(self.hosts)
