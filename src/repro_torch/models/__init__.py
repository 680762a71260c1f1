from repro_torch.models.api import (Model, build_model, input_specs,
                                    params_from_jax)

__all__ = ["Model", "build_model", "input_specs", "params_from_jax"]
