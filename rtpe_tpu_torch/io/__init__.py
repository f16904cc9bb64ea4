"""Weight import and export: the JAX package's variables <-> the port's
state dict (teacher and student), JAX's BN-folded dict -> the port's
serving dict, the serving artifact directory, written and read, the
reference's torch student state dicts -> the port's students
(``torch_import.py``), and the trainer's checkpoints and part snapshots
(``checkpoint.py``)."""

from .jax_import import (  # noqa: F401
    folded_params_from_jax,
    jax_variables_from_state_dict,
    jax_variables_from_student_state_dict,
    state_dict_from_jax,
    strip_fp16_prefix,
    student_state_dict_from_jax,
)
from .serving import (  # noqa: F401
    ServingArtifact,
    export_serving_artifact,
    load_serving_artifact,
)
from .torch_import import (  # noqa: F401
    import_attention_steps_statedict,
    import_attention_student_parts,
    import_attention_student_statedict,
    import_stem_statedict,
    import_student_statedict,
    load_torch_statedict,
)
