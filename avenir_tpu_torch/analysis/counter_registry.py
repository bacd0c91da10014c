"""Generated counter-group / span-site registry — DO NOT EDIT
BY HAND.

Regenerate with `python -m avenir_tpu_torch.analysis --write-registry`
after adding a counter group or span name.  Maps every
resolvable Counters group and tracer span literal in the code
tree to the doc file that documents it; None = undocumented
(GL008 fails the build on it).  F-string names are normalized
to wildcards ("Serving.*"), matching docs written as
"Serving.<model>".
"""

COUNTER_GROUPS = {
    'Aggregate': 'docs/observability.md',
    'Fleet': 'docs/architecture.md',
    'Groups': 'docs/observability.md',
    'Iterations': 'docs/observability.md',
    'Model': 'docs/observability.md',
    'Pool': 'docs/analysis.md',
    'Projection': 'docs/observability.md',
    'Records': 'docs/analysis.md',
    'Round': 'docs/observability.md',
    'Serving.*': 'docs/analysis.md',
    'Shard': 'docs/architecture.md',
    'SharedScan': 'docs/architecture.md',
    'Splits': 'docs/observability.md',
    'Stream': 'docs/analysis.md',
    'Task': 'docs/jobs.md',
    'Tenant.*': 'docs/multitenancy.md',
    'Tree': 'docs/observability.md',
    'TreePhase': 'docs/jobs.md',
    'Validation': 'docs/observability.md',
    'Words': 'docs/observability.md',
}

SPAN_SITES = {
    'acc.add': 'docs/observability.md',
    'acc.fetch': 'docs/observability.md',
    'chunk': 'docs/observability.md',
    'feeder.stage': 'docs/observability.md',
    'input.encode': 'docs/observability.md',
    'input.read': 'docs/observability.md',
    'job.*': 'docs/observability.md',
    'knn.fallback': 'docs/observability.md',
    'knn.fetch': 'docs/observability.md',
    'knn.launch': 'docs/observability.md',
    'knn.predict': 'docs/observability.md',
    'knn.prep': 'docs/observability.md',
    'knn.vote': 'docs/observability.md',
    'output.write': 'docs/observability.md',
    'pipeline.run': 'docs/observability.md',
    'scan': 'docs/observability.md',
    'scan.chunk': 'docs/observability.md',
    'scan.finalize': 'docs/observability.md',
    'scan.fused': 'docs/observability.md',
    'scan.launch': 'docs/observability.md',
    'scan.read': 'docs/observability.md',
    'serve.request': 'docs/architecture.md',
    'stage.*': 'docs/observability.md',
}
