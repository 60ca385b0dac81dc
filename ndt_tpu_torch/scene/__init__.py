from ndt_tpu_torch.scene.model import (  # noqa: F401
    Light,
    LightType,
    Object,
    Scene,
    object_types,
)
from ndt_tpu_torch.scene.compile import (  # noqa: F401
    SceneData,
    compile_scene,
    scene_from_numpy,
    to_device,
)
