"""``deepblast-train`` (reference: scripts/deepblast-train)."""

from __future__ import annotations

import argparse
import os

from deepblast_jax.cli.common import (
    add_infra_args,
    add_model_args,
    build_model,
    config_from_args,
)


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-train")
    add_infra_args(parser)
    add_model_args(parser)
    args = parser.parse_args(argv)

    if args.coordinator:
        from deepblast_jax.parallel import initialize_distributed
        initialize_distributed(args.coordinator, args.nodes, args.process_id)

    config = config_from_args(args)
    model = build_model(config, args.pretrain_path)

    from deepblast_jax.train.checkpoint import Checkpointer, save_config
    from deepblast_jax.utils.logging import MetricsLogger

    os.makedirs(args.output_directory, exist_ok=True)
    save_config(config, args.output_directory)
    logger = MetricsLogger(args.output_directory)
    ckpt = Checkpointer(os.path.join(args.output_directory, "checkpoints"))

    if args.load_from_checkpoint:
        import jax
        template = jax.eval_shape(model.init)
        prev = Checkpointer(args.load_from_checkpoint)
        model.state = prev.restore(template)

    # Engage the device mesh whenever more than one device is visible —
    # the reference's --devices/--nodes DDP path
    # (reference: scripts/deepblast-train:66-84); honours --tp.
    state, history = model.fit(logger=logger, checkpointer=ckpt,
                               mesh="auto")
    print(f"final: {history[-1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
