"""The port's hand-written kernels for Hopper.

Importing the package registers the custom ops that an exported program
(`tools/export_serving.py`) calls, `msml_torch::conv3x3_fwd`,
`msml_torch::prelu_fwd` and, for an int8 program, `msml_torch::quant_act`
and `msml_torch::qconv_int8`, without the model code of `msml_torch.nn`.
"""

from msml_torch.kernels import conv3x3, prelu, qconv  # noqa: F401
