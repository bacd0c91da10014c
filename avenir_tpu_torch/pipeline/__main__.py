"""CLI — the conf-declared pipeline as a runnable verb; port of
``avenir_tpu/pipeline/__main__.py``.

::

    python -m avenir_tpu_torch.pipeline run <conf> [-Dkey=value ...] [--resume] [--device cpu]

``run`` loads the pipeline the ``pipeline.*`` properties declare
(``Pipeline.from_conf``), runs it on ``cuda`` unless ``--device cpu`` is
given, and prints each stage's counters.  ``-D`` overrides apply over the
properties file, as in ``python -m avenir_tpu_torch``.  The ``plan`` verb
(the planner's explain) is not ported yet and raises.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

USAGE = (
    "usage: python -m avenir_tpu_torch.pipeline run <conf> "
    "[-Dkey=value ...] [--resume] [--device cuda|cpu]\n"
    "       python -m avenir_tpu_torch.pipeline plan [explain] <conf> "
    "[-Dkey=value ...]   (not ported yet)")


def parse_args(argv: List[str]
               ) -> Tuple[str, str, Dict[str, str], bool, Optional[str]]:
    """(verb, conf path, -D overrides, resume, device or None)."""
    if not argv or argv[0] not in ("plan", "run"):
        raise SystemExit(USAGE)
    verb = argv[0]
    rest = iter(argv[1:])
    overrides: Dict[str, str] = {}
    positional: List[str] = []
    resume = False
    device: Optional[str] = None
    for arg in rest:
        if arg == "--resume":
            resume = True
        elif arg == "--device":
            device = next(rest, None)
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
        elif verb == "plan" and arg == "explain" and not positional:
            continue           # ``plan explain`` — the same verb
        elif arg.startswith("--"):
            raise SystemExit(f"unknown option {arg!r}\n{USAGE}")
        else:
            positional.append(arg)
    if len(positional) != 1:
        raise SystemExit(USAGE)
    return verb, positional[0], overrides, resume, device


def main(argv: List[str]) -> int:
    verb, conf_path, overrides, resume, device = parse_args(argv)
    if verb == "plan":
        raise NotImplementedError(
            "pipeline plan: the planner (pipeline/plan.py) is not ported yet "
            "(ROADMAP.md, Queue 1 item 7c)")
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.pipeline.driver import Pipeline

    conf = JobConfig.from_file(conf_path)
    for k, v in overrides.items():
        conf.set(k, v)
    counters = Pipeline.from_conf(conf, device=device).run(resume=resume)
    for name in counters:
        print(f"stage {name}")
        for group, vals in sorted(counters[name].as_dict().items()):
            print(f"  {group}")
            for k, v in sorted(vals.items()):
                print(f"\t{k}={v}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
