"""Command dispatcher: ``python -m s1s2_torch <command> [args]``.

The JAX package's commands, for those the port has (each also runnable as
``python -m s1s2_torch.cli.<command>``); the others exit with code 2 and
name the ROADMAP item that ports them.
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
# commands of the JAX package the port does not have yet, with the ROADMAP
# item that ports them (none is left)
NOT_PORTED = {}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m s1s2_torch <command> [args]\ncommands: "
              + " ".join(sorted(COMMANDS))
              + ("\nnot ported yet: " + " ".join(sorted(NOT_PORTED)) if NOT_PORTED else ""))
        return 0 if argv else 2
    cmd = argv[0]
    if cmd in NOT_PORTED:
        print(f"s1s2_torch: {cmd!r} is not ported yet: {NOT_PORTED[cmd]}", file=sys.stderr)
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; expected one of: " + " ".join(sorted(COMMANDS)),
              file=sys.stderr)
        return 2
    import importlib

    importlib.import_module(COMMANDS[cmd]).main(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
