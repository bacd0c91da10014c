"""CLI — ``python -m avenir_tpu_torch <JobName> -Dconf.path=<props> <in> <out>
[--device cpu] [--resume]``, the same argument contract as
``python -m avenir_tpu``.

Accepts the reference's fully-qualified class names or simple names and
``-D`` property overrides (applied over the properties file, as Hadoop's
GenericOptionsParser does), and prints the job counters on completion.
Jobs run on ``cuda`` unless ``--device cpu`` is given.  ``--resume`` is
``-Dstream.resume=true``: a streamed count job with
``stream.checkpoint.dir`` continues from its latest snapshot.  Under the
fleet launcher (``AVENIR_NUM_PROCESSES`` set) the process joins the fleet
first and journals under the launcher's ``AVENIR_WRITER_SUFFIX``.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

USAGE = ("usage: python -m avenir_tpu_torch <JobName> [-Dkey=value ...] "
         "<input> <output> [--device cuda|cpu] [--resume]\n"
         "       python -m avenir_tpu_torch --list")


def parse_args(argv: List[str]) -> Tuple[str, Dict[str, str], List[str], Optional[str]]:
    """→ (job name, -D overrides, positional args, device or None)."""
    if not argv:
        raise SystemExit(USAGE)
    job_name = argv[0]
    overrides: Dict[str, str] = {}
    positional: List[str] = []
    device: Optional[str] = None
    args = iter(argv[1:])
    for arg in args:
        if arg == "--resume":
            overrides["stream.resume"] = "true"
        elif arg == "--device":
            device = next(args, None)
            if device is None:
                raise SystemExit("--device needs a value (cuda or cpu)")
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        elif arg.startswith("-D"):
            body = arg[2:]
            if "=" not in body:
                raise SystemExit(f"bad -D option (need -Dkey=value): {arg!r}")
            k, v = body.split("=", 1)
            overrides[k.strip()] = v.strip()
        elif arg.startswith("--"):
            raise SystemExit(f"unknown option {arg!r}\n{USAGE}")
        else:
            positional.append(arg)
    return job_name, overrides, positional, device


def main(argv: List[str]) -> int:
    import os

    # a worker spawned by the fleet launcher (python -m
    # avenir_tpu_torch.launch) carries its rank in the environment: join
    # the fleet before any device work, through the bounded join (a bad
    # coordinator raises the typed LaunchError, never hangs)
    if os.environ.get("AVENIR_NUM_PROCESSES"):
        from avenir_tpu_torch.launch import join_from_env

        join_from_env()
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs import REGISTRY, get_job

    if argv and argv[0] in ("--list", "list"):
        for name in sorted(k for k in REGISTRY if "." not in k):
            print(name)
        return 0
    job_name, overrides, positional, device = parse_args(argv)
    conf_path = overrides.pop("conf.path", None)
    conf = JobConfig.from_file(conf_path) if conf_path else JobConfig()
    for k, v in overrides.items():
        conf.set(k, v)
    # the launcher's journal-shard suffix, unless the conf names its own
    if os.environ.get("AVENIR_WRITER_SUFFIX") and \
            not conf.get("trace.writer.suffix"):
        conf.set("trace.writer.suffix", os.environ["AVENIR_WRITER_SUFFIX"])
    if len(positional) != 2:
        raise SystemExit(f"expected <input> <output>, got {positional}")
    counters = get_job(job_name).run(conf, positional[0], positional[1],
                                     device=device)
    for group, vals in sorted(counters.as_dict().items()):
        print(group)
        for k, v in sorted(vals.items()):
            print(f"\t{k}={v}")
    return 0


def cli() -> None:
    """Console-script entry point (``avenir-tpu-torch``, pyproject.toml)."""
    raise SystemExit(main(sys.argv[1:]))


if __name__ == "__main__":
    cli()
