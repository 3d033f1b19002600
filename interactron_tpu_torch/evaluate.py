"""Evaluation entry point of the port (counterpart of the root
evaluate.py): build the task and its evaluator (weights from seed 42, then
EVALUATOR.CHECKPOINT when it exists) and run a full evaluation with saved
results.

    python -m interactron_tpu_torch.evaluate --config_file configs/interactron.yaml

Runs on CUDA unless `--device cpu` is given, and raises without CUDA.
"""

from interactron_tpu_torch.utils.config import build_evaluator, build_model, get_args, get_config


def evaluate(argv=None):
    args = get_args(argv)
    config = get_config(args.config_file)
    task = build_model(config, device=args.device)
    evaluator = build_evaluator(task, config, load_checkpoint=True)
    return evaluator.evaluate(save_results=True)


if __name__ == "__main__":
    evaluate()
