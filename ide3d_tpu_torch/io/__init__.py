"""io layer of the PyTorch port (see the package docstring)."""

from .torch_import import (
    ImportReport,
    import_discriminator,
    import_encoder,
    import_generator,
    load_network_pkl,
    load_pickle_tensors,
    pickle_payload_to_state_dicts,
)
