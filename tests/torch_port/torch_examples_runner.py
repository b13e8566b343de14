"""Runs the port's example scripts for ``test_torch_examples.py``, each in
this process through ``example_lib_torch.run_example`` (its ``main()``
with the test's small arguments, the port's accelerator state reset
between scripts), and writes one JSON line a script: ``{"case", "script",
"argv", "seconds", "stdout", "error", "rank"}``, on the standard output, or
in a launched world in ``OUT_DIR/rank_<rank>.jsonl``.

    python torch_examples_runner.py single OUT_DIR
        every single-process case of ``SINGLE`` on the CPU, one after another
    python -m accelerate_tpu_torch.commands.accelerate_cli launch --use_cpu_emulation \\
        --num_processes N [MESH FLAGS] torch_examples_runner.py world OUT_DIR CASE...
        the ``WORLD`` cases named, in every process of a gloo world

``OUT_DIR`` holds what the scripts write (checkpoints, traces, metrics).
"""

import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
EXAMPLES = REPO / "examples"
FAST = ["--epochs", "1", "--batch_size", "16"]

#: case -> (script under examples/, arguments; "{out}" is OUT_DIR). The
#: arguments are ``tests/test_examples.py``'s for the JAX scripts.
SINGLE = {
    "gradient_accumulation": ("by_feature_torch/gradient_accumulation.py", FAST),
    "automatic_gradient_accumulation": ("by_feature_torch/automatic_gradient_accumulation.py",
                                        FAST),
    "checkpointing": ("by_feature_torch/checkpointing.py",
                      FAST + ["--project_dir", "{out}/ckpt"]),
    "checkpointing_resumed": ("by_feature_torch/checkpointing.py",
                              FAST + ["--project_dir", "{out}/ckpt", "--epochs", "2",
                                      "--resume_from_checkpoint", "latest"]),
    "early_stopping": ("by_feature_torch/early_stopping.py",
                       FAST + ["--epochs", "2", "--patience", "1", "--min_delta", "10.0"]),
    "local_sgd": ("by_feature_torch/local_sgd.py", FAST),
    "memory": ("by_feature_torch/memory.py", FAST),
    "multi_process_metrics": ("by_feature_torch/multi_process_metrics.py", FAST),
    "profiler": ("by_feature_torch/profiler.py", FAST + ["--trace_dir", "{out}/trace"]),
    "tracking": ("by_feature_torch/tracking.py", FAST + ["--project_dir", "{out}/track"]),
    "fsdp_with_peak_mem_tracking": ("by_feature_torch/fsdp_with_peak_mem_tracking.py",
                                    FAST + ["--cpu_offload", "--activation_checkpointing"]),
    "cross_validation": ("by_feature_torch/cross_validation.py", FAST + ["--num_folds", "2"]),
    "ddp_comm_hook": ("by_feature_torch/ddp_comm_hook.py", FAST),
    "schedule_free": ("by_feature_torch/schedule_free.py", FAST),
    "deepspeed_with_config_support": ("by_feature_torch/deepspeed_with_config_support.py",
                                      FAST),
    "native_data_pipeline": ("by_feature_torch/native_data_pipeline.py",
                             FAST + ["--seq_len", "64"]),
    "hf_checkpoint_finetune": ("by_feature_torch/hf_checkpoint_finetune.py",
                               FAST + ["--output_dir", "{out}/hf"]),
    "sequence_packing": ("by_feature_torch/sequence_packing.py", FAST + ["--seq_len", "32"]),
    "speculative_decoding": ("inference_torch/speculative_decoding.py", []),
    "nlp_example": ("nlp_example_torch.py", ["--epochs", "5", "--batch_size", "16"]),
    "cv_example": ("cv_example_torch.py", ["--epochs", "1", "--batch_size", "16"]),
}
#: Cases run without ``--cpu`` (first, before the process's device is set):
#: on a machine without a card they must fail.
NO_CARD = {
    "nlp_example_torch.py": ("nlp_example_torch.py", ["--epochs", "1"]),
    "cv_example_torch.py": ("cv_example_torch.py", ["--epochs", "1"]),
}
#: The cases of the launched gloo worlds (the mesh comes from the scripts'
#: flags, or, for pipeline_inference, from the launch's ``--pp 2 --tp 2``).
WORLD = {
    "megatron_lm_gpt_pretraining": ("by_feature_torch/megatron_lm_gpt_pretraining.py",
                                    FAST + ["--tp", "2", "--pp", "2", "--steps", "4"]),
    "moe_context_parallel": ("by_feature_torch/moe_context_parallel.py",
                             FAST + ["--steps", "4"]),
    "pipeline_inference": ("inference_torch/pipeline_inference.py", []),
    "distributed_inference": ("inference_torch/distributed_inference.py", []),
}


def run(case: str, script: str, argv: list, out: str, rank: int = 0, sink=None) -> None:
    from example_lib_torch import run_example

    result = run_example(EXAMPLES / script, [a.replace("{out}", out) for a in argv])
    print(json.dumps({"case": case, "rank": rank, **result}), file=sink or sys.stdout,
          flush=True)


def main(mode: str, out: str, *cases: str) -> None:
    import torch

    sys.path.insert(0, str(EXAMPLES))
    torch.set_num_threads(1)
    os.makedirs(out, exist_ok=True)
    if mode == "single":
        from accelerate_tpu_torch.state import PartialState

        for case, (script, argv) in NO_CARD.items():
            run(case, script, argv, out)
            PartialState._reset_state()
        for case, (script, argv) in SINGLE.items():
            run(case, script, [*argv, "--cpu"], out)
    else:
        from accelerate_tpu_torch.state import PartialState

        rank = PartialState(cpu=True).process_index  # joins the launched world
        with open(os.path.join(out, f"rank_{rank}.jsonl"), "w") as sink:
            for case in cases:
                script, argv = WORLD[case]
                run(case, script, argv, out, rank, sink)


if __name__ == "__main__":
    main(*sys.argv[1:])
