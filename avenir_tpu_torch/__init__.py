"""avenir_tpu_torch — the PyTorch/CUDA port of avenir_tpu.

The same jobs, properties keys and CSV-in/CSV-out contract as ``avenir_tpu``,
run with PyTorch on an NVIDIA GPU.  Plain tensor code is PyTorch; the count
kernel the JAX package wrote in Pallas is a hand-written CUDA kernel
(``csrc/cooc.cu``, bound through ``ops/hist.py``).

Layers, entry point first:

  ``__main__`` / ``jobs``   the CLI contract (BayesianDistribution,
                            BayesianPredictor, MutualInformation)
  ``models``                NaiveBayes and MutualInformation fit/predict
  ``ops``                   count tensors (``agg``), statistics (``info``),
                            the co-occurrence gram (``hist``) and its kernel
  ``core``                  schema, properties, CSV and encoding (numpy)

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, CLI ``--device cpu``); without CUDA and without that
request they raise (:func:`avenir_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
