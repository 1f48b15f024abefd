"""A configuration's inputs, handed to both sides: the scene XML, which
the program loads and the reference reads on its own."""

from __future__ import annotations

import os

from portbench.reference import scene as ref_scene


def image_seed(seed, k):
    """The render seed of the window's k-th image (k = -1: the warm-up)."""
    return (int(seed) + (k + 1) * 0x9E3779B1) & 0xFFFFFFFF


def scene_xml(config):
    """The configuration's scene XML, from the file beside it."""
    with open(os.path.join(config["dir"], config["scene"])) as f:
        return f.read()


def program_scene(xml, width, height):
    """The program's scene of `xml` at the traffic's film size."""
    import mitsuba_tpu_torch as mt

    scene = mt.load_scene_string(xml)
    film = scene.sensor.record.film
    film.width, film.height = width, height
    return scene


def reference_scene(xml, width, height):
    return ref_scene.load(xml, width=width, height=height)
