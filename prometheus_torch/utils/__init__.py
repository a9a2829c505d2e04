from .cameras import (camera_c2w, camera_fov, camera_intrinsics,
                      check_valid_rotations, get_random_cameras,
                      llff_to_opengl, look_at, make_camera, matrix_to_square,
                      normalize_poses, opencv_to_opengl, opengl_to_opencv,
                      sample_from_dense_cameras, sample_from_two_poses)
from .device import resolve_device
from .quaternion import (matrix_to_quaternion, quaternion_multiply,
                         quaternion_normalize, quaternion_slerp,
                         quaternion_to_matrix)
from .rays import (embed_rays, raymap, sample_patch_indices, sample_rays,
                   sample_rays_at)

__all__ = [
    "camera_c2w", "camera_fov", "camera_intrinsics", "check_valid_rotations",
    "embed_rays", "get_random_cameras", "llff_to_opengl", "look_at",
    "make_camera", "matrix_to_quaternion", "matrix_to_square",
    "normalize_poses", "opencv_to_opengl", "opengl_to_opencv",
    "quaternion_multiply", "quaternion_normalize", "quaternion_slerp",
    "quaternion_to_matrix", "raymap", "resolve_device",
    "sample_from_dense_cameras", "sample_from_two_poses",
    "sample_patch_indices", "sample_rays", "sample_rays_at",
]
