"""Command dispatcher: ``python -m s1s2_torch <command> [args]``.

The JAX package's commands, every one of which the port has (each also
runnable as ``python -m s1s2_torch.cli.<command>``); an unknown command
exits with code 2.
"""

import sys

COMMANDS = {
    "evaluate": "s1s2_torch.cli.evaluate",
    "quantize": "s1s2_torch.cli.quantize",
    "infer_scene": "s1s2_torch.cli.infer_scene",
    "serve": "s1s2_torch.cli.serve",
    "train": "s1s2_torch.cli.train",
    "distill": "s1s2_torch.cli.distill",
    "make_synthetic": "s1s2_torch.cli.make_synthetic",
    "patchify": "s1s2_torch.cli.patchify",
    "convert_ckpt": "s1s2_torch.cli.convert_ckpt",
    "validate_parity": "s1s2_torch.cli.validate_parity",
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m s1s2_torch <command> [args]\ncommands: "
              + " ".join(sorted(COMMANDS)))
        return 0 if argv else 2
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; expected one of: " + " ".join(sorted(COMMANDS)),
              file=sys.stderr)
        return 2
    import importlib

    importlib.import_module(COMMANDS[cmd]).main(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
