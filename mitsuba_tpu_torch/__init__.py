"""mitsuba_tpu_torch — the PyTorch + CUDA port of mitsuba_tpu for NVIDIA
Hopper GPUs.

The module tree mirrors `mitsuba_tpu/`; the JAX package is the
reference each module is tested against.  Plain tensor code is PyTorch,
and every TPU kernel the ported slice reaches is a hand-written CUDA
kernel under `csrc/`, compiled with nvcc at first use (native.py).
Entry points run on the card (`device="cuda"`) unless the caller asks
for another device, as the CPU tests do with `device="cpu"`.

    scene = load_scene("scenes/cbox.xml")
    img = render(scene, spp=16, seed=0)  # on the card; numpy [H, W, 3]
"""

from mitsuba_tpu_torch.renderer import render
from mitsuba_tpu_torch.scene.xml_loader import load_scene, load_scene_string

__all__ = ["load_scene", "load_scene_string", "render"]
