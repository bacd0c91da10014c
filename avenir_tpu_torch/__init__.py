"""avenir_tpu_torch — the PyTorch/CUDA port of avenir_tpu.

The same jobs, properties keys and CSV-in/CSV-out contract as ``avenir_tpu``,
run with PyTorch on an NVIDIA GPU.  Plain tensor code is PyTorch; every
kernel the JAX package wrote in Pallas on these paths is a hand-written
CUDA kernel (``csrc/``, built on first use by ``ops/_build.py``).

Layers, entry point first:

  ``__main__`` / ``jobs``   the CLI contract (NB, MI, tree and kNN jobs)
  ``stream``                windowed analytics (``StreamAnalytics``), drift,
                            refit and hot swap into ``serving``
  ``tenancy``               the arbiter every fold and serving dispatch
                            draws a slot from under ``tenant.*`` contracts
  ``models``                NaiveBayes, MutualInformation, DecisionTree, KNN
  ``ops``                   count tensors (``agg``), statistics (``info``),
                            the co-occurrence grams (``hist``), the kNN
                            candidate search (``knn``) and their kernels
  ``core``                  schema, properties, CSV and encoding (numpy)
  ``analysis``              graftlint, the static gate over the port's own
                            sources (stdlib only: ``python -m
                            avenir_tpu_torch.analysis``)

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, CLI ``--device cpu``); without CUDA and without that
request they raise (:func:`avenir_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
