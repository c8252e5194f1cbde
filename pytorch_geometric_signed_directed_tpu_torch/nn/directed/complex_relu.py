"""Complex ReLU: mask both parts by (real >= 0)."""
import torch

from ...instrument import layer


@layer("nn.complex_relu")
def complex_relu(real: torch.Tensor, imag: torch.Tensor):
    mask = (real >= 0).to(real.dtype)
    return mask * real, mask * imag


class complex_relu_layer(torch.nn.Module):
    """Module form, under the original library's layer name."""

    def forward(self, real, imag):
        return complex_relu(real, imag)
