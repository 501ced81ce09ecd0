"""Model output container: a dict with attribute access, as the JAX
package's ``rlvae_tpu/utils/output.py`` (without the pytree registration)."""

from __future__ import annotations


class ModelOutput(dict):
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value
