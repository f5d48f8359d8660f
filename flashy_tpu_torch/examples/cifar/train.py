"""Train a ResNet (or ViT) on CIFAR-10: the port of
examples/cifar/train.py.

    python -m flashy_tpu_torch.examples.cifar.train [key=value ...]

Builds the loaders (`distrib.loader`: training shuffled into equal
shards, eval padded and masked), the solver, and runs it; real CIFAR-10
when a local copy exists, the synthetic stand-in otherwise. It runs on
the card; `device=cpu` runs it on the host. `--workers=N` runs N
data-parallel processes. `get_solver_from_sig` re-attaches to an XP.
"""
from ... import distrib
from ...logging import setup_logging
from ...xp import main as xp_main
from .data import CifarDataset, load_cifar10
from .solver import Solver


def get_solver(cfg) -> Solver:
    x_train, y_train, x_test, y_test, is_real = load_cifar10(
        cfg.get("data_root"))
    train_set = CifarDataset(x_train, y_train, augment=True)
    valid_set = CifarDataset(x_test, y_test)
    loaders = {
        # shuffle=True: equal per-process shards (training); eval uses
        # padded, masked shards so every process runs as many eval steps
        # and the metrics equal an unsharded eval's
        "train": distrib.loader(train_set, batch_size=cfg.batch_size,
                                shuffle=True, num_workers=4),
        "valid": distrib.loader(valid_set, batch_size=cfg.batch_size,
                                pad_to_even=True, num_workers=4),
    }
    solver = Solver(cfg, loaders, is_real=is_real, device=cfg.get("device"))
    solver.logger.info("CIFAR-10 data: %s", "real" if is_real
                       else "synthetic")
    return solver


@xp_main(config_path="config")
def main(cfg):
    """Train on CIFAR-10; returns the solver."""
    setup_logging()
    distrib.init(backend="gloo" if cfg.get("device") == "cpu" else None)
    solver = get_solver(cfg)
    solver.run()
    return solver


def get_solver_from_sig(sig: str) -> Solver:
    """Re-attach to a finished or running XP (from a notebook)."""
    xp = main.get_xp_from_sig(sig)
    with xp.enter():
        solver = get_solver(xp.cfg)
        solver.restore()
    return solver


if __name__ == "__main__":
    main()
