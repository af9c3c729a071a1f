"""The port's hand-written kernels for Hopper.

Importing the package registers the custom ops that an exported program
(`tools/export_serving.py`) calls, `msml_torch::conv3x3_fwd` and
`msml_torch::prelu_fwd`, without the model code of `msml_torch.nn`.
"""

from msml_torch.kernels import conv3x3, prelu  # noqa: F401
