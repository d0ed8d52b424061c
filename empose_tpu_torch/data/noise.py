"""Sensor-fault augmentation (port of ``empose_tpu/data/noise.py``).

``make_noise_fn`` picks at most one noise type from the configuration. The
no-noise branch is ported; the spherical displacement and the marker
suppression branches are not yet and raise.
"""

from __future__ import annotations

NOT_PORTED = ("{} noise is not ported yet: ROADMAP.md, queue 1, 'Noise functions'")


def make_noise_fn(config, randomize_if_configured: bool, is_valid: bool = False):
    """``noise(batch, generator) -> batch`` (``make_noise_fn`` of the JAX
    package); raises for the branches not yet ported."""
    def no_noise(batch, generator):
        return batch

    if randomize_if_configured:
        if config.spherical_noise_length > 0.0:
            if config.suppression_noise_length > 0.0:
                raise ValueError("Only one noise type at a time.")
            raise NotImplementedError(NOT_PORTED.format("Spherical marker"))
        if config.suppression_noise_length > 0.0:
            raise NotImplementedError(NOT_PORTED.format("Marker suppression"))
        return no_noise
    if is_valid and config.suppression_noise_length > 0.0:
        raise NotImplementedError(NOT_PORTED.format("Marker suppression"))
    return no_noise
