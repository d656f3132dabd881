"""Projective geometry of the full-resolution archive, and the (vtk-gated)
interactive 3D scene viewer (JAX counterpart: ``deepfluoro_tpu/viz/
projective.py``).

The geometry follows the reference example (examples_dataset/
full_res_3d_viz.py): the focal length from the intrinsic's diagonal scaled
by the pixel spacings (:185), homogeneous 2D pixel indices mapped to 3D
points on the detector plane through the inverse intrinsic (:169-175), the
ground-truth poses composed with the archive's extrinsic into
volume -> camera-projective transforms (:215-217), the ITK index ->
physical matrix of the label volume (:252-257) and rigid inversion
(:130-138). The camera frame is hdf5_layouts/Readme.md:81-93's: origin at
the X-ray source, +Z orthogonal to the detector and pointing at the
source (the detector plane at z = -focal_len).

The geometry is float64 tensor functions: array-like inputs become float64
tensors on the device of the tensor given, else on the CPU. The viewer
computes on the caller's device (CUDA unless asked for the CPU). The renderer
needs the optional ``vtk`` package (on neither the tests' machine nor the
card's), imported inside ``view_3d_scene``, which raises the JAX package's
ImportError without it; h5py is imported there too.
"""

from __future__ import annotations

import numpy as np
import torch

from deepfluoro_tpu_torch.utils.platform import get_device


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


def invert_rigid(xform) -> torch.Tensor:
    """Closed-form inverse of a 4x4 rigid transform."""
    xform = _f64(xform)
    if tuple(xform.shape) != (4, 4):
        raise ValueError("a rigid transform is 4x4, got {}".format(tuple(xform.shape)))
    inv = torch.eye(4, dtype=torch.float64, device=xform.device)
    r_t = xform[:3, :3].T
    inv[:3, :3] = r_t
    inv[:3, 3] = -(r_t @ xform[:3, 3])
    return inv


def focal_len_from_intrinsic(intrinsic, pixel_row_spacing: float, pixel_col_spacing: float | None = None) -> float:
    """Source-to-detector distance in mm, ``|K[0,0] * col_spacing + K[1,1] *
    row_spacing| / 2`` (full_res_3d_viz.py:185: the diagonal focal terms may
    be negative, so the signed sum is averaged before its magnitude). With
    one spacing it serves both axes."""
    if pixel_col_spacing is None:
        pixel_col_spacing = pixel_row_spacing
    k = _f64(intrinsic)
    return float(abs(k[0, 0] * pixel_col_spacing + k[1, 1] * pixel_row_spacing) / 2.0)


def pixel_index_to_detector_pt(idx_xy, intrinsic, pixel_row_spacing: float, pixel_col_spacing: float) -> torch.Tensor:
    """A 2D pixel index (col, row) -> its 3D point on the detector plane in
    the camera projective frame, ``inv(K) @ [col, row, 1] * -focal_len``
    (full_res_3d_viz.py:169-175, 187-193): the stored intrinsic's signs are
    kept, not a positive diagonal assumed."""
    k = _f64(intrinsic)
    focal = focal_len_from_intrinsic(k, pixel_row_spacing, pixel_col_spacing)
    h = torch.tensor([float(idx_xy[0]), float(idx_xy[1]), 1.0], dtype=torch.float64, device=k.device)
    return torch.linalg.inv(k) @ h * -focal


def vol_to_camera_xform(cam_to_vol, extrinsic=None) -> torch.Tensor:
    """The ground-truth poses map the camera world frame to the volume frame
    (hdf5_layouts/Readme.md:56-60); points in volume coordinates go to the
    camera PROJECTIVE frame by ``extrinsic @ invert_rigid(cam_to_vol)``
    (full_res_3d_viz.py:215-217). ``extrinsic`` is the archive's world ->
    camera-projective rigid transform (proj-params/extrinsic); None is the
    identity."""
    out = invert_rigid(cam_to_vol)
    if extrinsic is not None:
        out = _f64(extrinsic).to(out.device) @ out
    return out


def index_to_physical_matrix(spacing, dir_mat, origin) -> torch.Tensor:
    """The ITK 4x4 from voxel indices (x, y, z order) to physical mm points:
    column c of the rotation is ``dir_mat[:, c] * spacing[c]``, the
    translation the origin (full_res_3d_viz.py:252-257; image group schema
    hdf5_layouts/Readme.md:20-28)."""
    dir_mat = _f64(dir_mat)
    m = torch.eye(4, dtype=torch.float64, device=dir_mat.device)
    m[:3, :3] = dir_mat * _f64(spacing).reshape(-1).to(dir_mat.device)[None, :]
    m[:3, 3] = _f64(origin).reshape(-1).to(dir_mat.device)
    return m


def source_to_detector_rays(corners_xy, intrinsic, pixel_row_spacing: float, pixel_col_spacing: float) -> torch.Tensor:
    """(n, 2, 3): rays, as pairs of 3D points, from the X-ray source (the
    origin) to detector points at the pixel indices ``corners_xy``
    (full_res_3d_viz.py:334-352)."""
    ends = [pixel_index_to_detector_pt(c, intrinsic, pixel_row_spacing, pixel_col_spacing) for c in corners_xy]
    return torch.stack([torch.stack([torch.zeros_like(e), e]) for e in ends])


def view_3d_scene(h5_path: str, spec_id: str, proj_index: int = 0, device=None) -> None:
    """The interactive VTK scene of full_res_3d_viz.py:141-448: the CT
    surface meshes in physical mm posed per body (hemipelves by the pelvis
    pose, each femur by its own), the 3D landmarks in the camera frame, the
    X-ray source, the in-view 2D landmarks on the detector plane with their
    projection rays, rays from the source to the detector's corners, and the
    textured detector plane. The geometry runs on ``device`` (CUDA unless
    the caller asks for the CPU) and reaches VTK as host numbers. Needs the
    optional ``vtk`` package."""
    try:
        import vtk  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "3D visualization requires the optional 'vtk' package "
            "(pip install vtk); the projective-geometry math in this module "
            "works without it."
        ) from e

    import h5py
    from vtk.util import numpy_support

    dev = get_device(device)

    def on_dev(x):
        return _f64(np.asarray(x)).to(dev)

    with h5py.File(h5_path, "r") as f:
        pp = f["proj-params"]
        extrinsic = on_dev(pp["extrinsic"][:])
        intrinsic = on_dev(pp["intrinsic"][:])
        row_sp = float(np.asarray(pp["pixel-row-spacing"][()]))
        col_sp = float(np.asarray(pp["pixel-col-spacing"][()]))
        num_cols = int(np.asarray(pp["num-cols"][()]))
        num_rows = int(np.asarray(pp["num-rows"][()]))

        sg = f[spec_id]
        seg_img = sg["vol-seg/image"]
        vol_seg = np.asarray(seg_img["pixels"][:])
        idx_to_phys = index_to_physical_matrix(
            on_dev(seg_img["spacing"][:]), on_dev(seg_img["dir-mat"][:]), on_dev(seg_img["origin"][:]))
        pg = sg["projections/{:03d}".format(proj_index)]
        proj_img = torch.from_numpy(np.asarray(pg["image/pixels"][:], np.float32))
        poses = {name: on_dev(pg["gt-poses/cam-to-{}-vol".format(name)][:])
                 for name in ("pelvis", "left-femur", "right-femur")}
        lands_3d = {k: on_dev(np.asarray(sg["vol-landmarks"][k][:]).ravel()[:3]) for k in sg["vol-landmarks"]}
        lands_2d = {}
        if "gt-landmarks" in pg:
            for k in pg["gt-landmarks"]:
                l2 = np.asarray(pg["gt-landmarks"][k][:]).ravel()[:2]
                if 0 <= l2[0] < num_cols - 1 and 0 <= l2[1] < num_rows - 1:
                    lands_2d[k] = l2

    def detector_pt(idx_xy):
        return pixel_index_to_detector_pt(idx_xy, intrinsic, row_sp, col_sp).cpu()

    body_to_cam = {name: vol_to_camera_xform(pose, extrinsic) for name, pose in poses.items()}

    renderer = vtk.vtkRenderer()
    renderer.SetBackground(0.1, 0.1, 0.15)

    def as_vtk_mat(m):
        m = m.cpu()
        vm = vtk.vtkMatrix4x4()
        for i in range(4):
            for j in range(4):
                vm.SetElement(i, j, float(m[i, j]))
        return vm

    # numpy (z, y, x) raveled buffers enter VTK with a flipped y vertex
    # convention; the reference corrects it with diag(1, -1, 1) + (ydim + 1)
    # before mapping indices to physical points (full_res_3d_viz.py:70-76)
    y_flip = torch.eye(4, dtype=torch.float64, device=dev)
    y_flip[1, 1] = -1.0
    y_flip[1, 3] = vol_seg.shape[1] + 1

    def add_mesh(label, color, vol_to_cam):
        img = vtk.vtkImageData()
        dims = vol_seg.shape  # (z, y, x)
        img.SetDimensions(dims[2], dims[1], dims[0])
        img.GetPointData().SetScalars(numpy_support.numpy_to_vtk((vol_seg == label).astype(np.uint8).ravel(), deep=True))
        # the reference flips the image along axis 1 before marching cubes
        # (full_res_3d_viz.py:84-89, 120-123); that flip and the y_flip
        # vertex matrix compose to about the identity (a 2-voxel y offset),
        # so dropping either would mirror every mesh along y against the
        # landmarks, poses and detector of the same scene
        flip = vtk.vtkImageFlip()
        flip.SetInputData(img)
        flip.SetFilteredAxis(1)
        flip.Update()
        mc = vtk.vtkMarchingCubes()
        mc.SetInputData(flip.GetOutput())
        mc.SetValue(0, 0.5)
        mapper = vtk.vtkPolyDataMapper()
        mapper.SetInputConnection(mc.GetOutputPort())
        mapper.ScalarVisibilityOff()
        actor = vtk.vtkActor()
        actor.SetMapper(mapper)
        actor.GetProperty().SetColor(*color)
        # voxel indices -> physical mm -> this body's camera-frame pose
        actor.SetUserMatrix(as_vtk_mat(vol_to_cam @ idx_to_phys @ y_flip))
        renderer.AddActor(actor)

    # the reference's bodies and colors (full_res_3d_viz.py:262-297): left
    # hemipelvis green, right red, left femur cyan, right femur orange; the
    # femurs carry their own ground-truth poses
    add_mesh(1, (0.0, 1.0, 0.0), body_to_cam["pelvis"])
    add_mesh(2, (1.0, 0.0, 0.0), body_to_cam["pelvis"])
    add_mesh(5, (0.0, 1.0, 1.0), body_to_cam["left-femur"])
    add_mesh(6, (1.0, 0.5, 0.0), body_to_cam["right-femur"])

    def add_sphere(pt, color, radius):
        s = vtk.vtkSphereSource()
        s.SetCenter(float(pt[0]), float(pt[1]), float(pt[2]))
        s.SetThetaResolution(20)
        s.SetPhiResolution(20)
        s.SetRadius(radius)
        mapper = vtk.vtkPolyDataMapper()
        mapper.SetInputConnection(s.GetOutputPort())
        a = vtk.vtkActor()
        a.SetMapper(mapper)
        a.GetProperty().SetColor(*color)
        renderer.AddActor(a)

    def add_line(p1, p2, color, width=2):
        line = vtk.vtkLineSource()
        line.SetPoint1(*[float(v) for v in p1])
        line.SetPoint2(*[float(v) for v in p2])
        mapper = vtk.vtkPolyDataMapper()
        mapper.SetInputConnection(line.GetOutputPort())
        a = vtk.vtkActor()
        a.SetMapper(mapper)
        a.GetProperty().SetColor(*color)
        a.GetProperty().SetLineWidth(width)
        renderer.AddActor(a)

    # the 3D landmarks are in pelvis-volume coordinates -> camera frame
    pelvis = body_to_cam["pelvis"]
    lands_3d_cam = {k: (pelvis @ torch.cat([pt, pt.new_ones(1)]))[:3] for k, pt in lands_3d.items()}
    for pt in lands_3d_cam.values():
        add_sphere(pt.cpu(), (0.5, 0.0, 0.5), 5.0)

    # the X-ray source sits at the camera frame's origin
    add_sphere((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 10.0)

    # in-view 2D landmarks on the detector plane, and the ray through the
    # matching 3D landmark's projection (the two should align)
    for name, l2 in lands_2d.items():
        add_sphere(detector_pt(l2), (0.0, 1.0, 0.0), 2.5)
        if name in lands_3d_cam:
            proj = intrinsic @ lands_3d_cam[name]
            proj = proj / proj[2]
            add_line((0, 0, 0), detector_pt(proj[:2]), (0.0, 1.0, 0.0))

    corners = [(0, 0), (num_cols - 1, 0), (num_cols - 1, num_rows - 1), (0, num_rows - 1)]
    for ray in source_to_detector_rays(corners, intrinsic, row_sp, col_sp).cpu():
        add_line(ray[0], ray[1], (0.8, 0.8, 0.8))

    # the textured detector plane: the normalized projection draped over the
    # quad of the corner detector points (full_res_3d_viz.py:354-403)
    p01 = proj_img - proj_img.min()
    denom = p01.max() if p01.max() > 0 else 1.0
    tex_pix = (255.0 * p01 / denom).to(torch.uint8).numpy()
    tex_img = vtk.vtkImageData()
    tex_img.SetDimensions(tex_pix.shape[1], tex_pix.shape[0], 1)
    tex_img.GetPointData().SetScalars(numpy_support.numpy_to_vtk(tex_pix.ravel(), deep=True))
    texture = vtk.vtkTexture()
    texture.SetInputData(tex_img)

    points = vtk.vtkPoints()
    for c in corners:
        points.InsertNextPoint(*(float(v) for v in detector_pt(c)))
    quad = vtk.vtkQuad()
    for i in range(4):
        quad.GetPointIds().SetId(i, i)
    cells = vtk.vtkCellArray()
    cells.InsertNextCell(quad)
    poly = vtk.vtkPolyData()
    poly.SetPoints(points)
    poly.SetPolys(cells)
    tcoords = vtk.vtkFloatArray()
    tcoords.SetNumberOfComponents(2)
    for uv in ((0, 0), (1, 0), (1, 1), (0, 1)):
        tcoords.InsertNextTuple2(*uv)
    poly.GetPointData().SetTCoords(tcoords)
    quad_mapper = vtk.vtkPolyDataMapper()
    quad_mapper.SetInputData(poly)
    quad_actor = vtk.vtkActor()
    quad_actor.SetMapper(quad_mapper)
    quad_actor.SetTexture(texture)
    renderer.AddActor(quad_actor)

    window = vtk.vtkRenderWindow()
    window.AddRenderer(renderer)
    window.SetSize(1024, 768)
    interactor = vtk.vtkRenderWindowInteractor()
    interactor.SetRenderWindow(window)
    window.Render()
    interactor.Start()
