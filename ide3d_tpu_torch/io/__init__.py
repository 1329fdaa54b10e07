"""io layer of the PyTorch port (see the package docstring)."""

from .torch_import import (
    ImportReport,
    import_bisenet,
    import_discriminator,
    import_encoder,
    import_generator,
    load_network_pkl,
    load_pickle_tensors,
    load_torch_file_stubbed,
    load_torch_state_dict,
    pickle_payload_to_state_dicts,
    state_dict_of,
)
