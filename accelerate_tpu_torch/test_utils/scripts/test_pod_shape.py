"""A world of several "hosts", driven two ways.

Counterpart of ``accelerate_tpu/test_utils/scripts/test_pod_shape.py``.
The reference runs 2 hosts of 4 devices each (one process a host); a
torch process drives one device, so here a host is one process and the
world is 2 hosts of one:

* ``accelerate-tpu-torch launch --use_cpu_emulation --num_machines 2
  --machine_rank R --main_process_ip 127.0.0.1 --main_process_port P
  --module ...test_pod_shape``, once a host: the coordinator comes from the
  flags (``ClusterConfig.launch_env``);
* ``--notebook``: the same world through :func:`notebook_launcher` with
  ``num_nodes=2`` (rank and port from ``ATPU_TEST_NB_{RANK,PORT}``).

Checks: the topology is 2 hosts of one process; ``process_index`` is the
launched machine rank; ``make_global_batch`` of the global batch on a dp
mesh keeps this host's rows, and an all-gather of every host's rows gives
the global batch back in rank order; a sum over the world sees every
host's contribution.
"""

import numpy as np


def world_checks():
    import os

    import torch

    from accelerate_tpu_torch import MeshConfig, PartialState
    from accelerate_tpu_torch.data_loader import make_global_batch
    from accelerate_tpu_torch.utils.operations import gather, reduce

    state = PartialState(cpu=True)
    assert state.num_processes == 2, f"process_count {state.num_processes}"
    expected_rank = int(os.environ.get("ATPU_TEST_EXPECT_RANK", "-1"))
    if expected_rank >= 0:
        assert state.process_index == expected_rank, (state.process_index, expected_rank)
    print(f"[rank {state.process_index}] topology ok", flush=True)

    mesh = MeshConfig(dp=2).build()
    want = np.concatenate([np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + 100.0 * r
                           for r in range(2)])
    batch = make_global_batch({"x": want}, "cpu", mesh=mesh)
    x = batch["x"]
    assert tuple(x.shape) == (8, 3), x.shape
    np.testing.assert_array_equal(x.numpy(), want[8 * state.process_index:8 * (state.process_index + 1)])
    np.testing.assert_array_equal(gather(x).numpy(), want)
    print(f"[rank {state.process_index}] make_global_batch ok", flush=True)

    total = reduce(x.sum())
    np.testing.assert_allclose(float(total), float(want.sum()))
    assert isinstance(total, torch.Tensor)
    print(f"[rank {state.process_index}] cross-host reduction ok", flush=True)
    print("All pod-shape checks passed", flush=True)


def main():
    world_checks()


def notebook_main():
    """The same world through notebook_launcher's multi-node variables."""
    import os

    from accelerate_tpu_torch.launchers import notebook_launcher

    rank = int(os.environ["ATPU_TEST_NB_RANK"])
    port = os.environ["ATPU_TEST_NB_PORT"]
    os.environ["ATPU_TEST_EXPECT_RANK"] = str(rank)
    os.environ["ACCELERATE_TPU_USE_CPU"] = "true"
    notebook_launcher(world_checks, num_nodes=2, node_rank=rank, master_addr="127.0.0.1",
                      use_port=port)


if __name__ == "__main__":
    import sys

    if "--notebook" in sys.argv:
        notebook_main()
    else:
        main()
