from .latent_editor import (
    LevelsMapper,
    apply_ganspace_edit,
    apply_interfacegan,
    compute_ganspace_pca,
)
