"""The port's datagen (``tpu3dsis_torch/datagen/``) against the JAX
package's (``tpu3dsis/datagen/``), on the CPU at tiny sizes.

Each case runs one function, or one short composition, of both packages on
the same inputs, each writing into a directory of its own: every returned
array is equal (dtype, shape, values, NaNs in place), every other value
equal, and the two directories hold the same files byte for byte. JPEG
bytes depend on PIL's version, so both packages write in this one process.
"""

import os
import types

import numpy as np
import pytest
from test_datagen import _room_mesh, _sphere_sdf, _write_sens
from test_torch_export import _same_tree

import tpu3dsis.datagen.marching_tets as jax_mt
import tpu3dsis.datagen.mesh_render as jax_mr
import tpu3dsis.datagen.prepare_2d as jax_p2
import tpu3dsis.datagen.scene_sampler as jax_ss
import tpu3dsis.datagen.synthetic_color as jax_sc
import tpu3dsis.datagen.tsdf_fusion as jax_tf
import tpu3dsis.datagen.virtual_scan as jax_vs
from tpu3dsis_torch.datagen import (marching_tets, mesh_render, prepare_2d, scene_sampler, synthetic_color,
                                    tsdf_fusion, virtual_scan)

PACKAGES = {
    "port": types.SimpleNamespace(tf=tsdf_fusion, mr=mesh_render, mt=marching_tets, ss=scene_sampler,
                                  vs=virtual_scan, sc=synthetic_color, p2=prepare_2d),
    "jax": types.SimpleNamespace(tf=jax_tf, mr=jax_mr, mt=jax_mt, ss=jax_ss, vs=jax_vs, sc=jax_sc, p2=jax_p2),
}


def _same(a, b, root_a, root_b, where="out"):
    """Deep equality, paths under the two output roots taken as relative."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), where
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], root_a, root_b, f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, root_a, root_b, f"{where}[{i}]")
    elif isinstance(a, str):
        assert a.replace(root_a, "<out>") == b.replace(root_b, "<out>"), where
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        _same(vars(a), vars(b), root_a, root_b, f"{where}.{type(a).__name__}")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
    else:
        assert a == b, (where, a, b)


def _wall_frames():
    """tests/test_datagen.py's frontal wall, seen from two poses, with labels."""
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 50.0
    K[0, 2], K[1, 2] = 32, 24
    frames = []
    for dx in (0.0, 0.1):
        pose = np.eye(4)
        pose[0, 3] = dx
        depth = np.full((48, 64), 1.0, np.float32)
        depth[10:20, 5:30] = 0.8
        label = np.full((48, 64), 7, np.uint8)
        label[10:20, 5:30] = 5
        inst = (label == 5).astype(np.uint8) + 1
        frames.append((K, pose, depth, label, inst))
    return frames


def case_fuse_scene(m, out):
    grid, w2g = m.tf.fuse_scene(_wall_frames(), ((-0.3, -0.3, 0.5), (0.3, 0.3, 1.3)), voxel_size=0.05, pad=4,
                                debug_mesh_path=os.path.join(out, "fused.ply"))
    lo = np.array(np.nonzero(np.abs(grid.sdf) <= 1.0)).min(axis=1)
    hi = np.array(np.nonzero(np.abs(grid.sdf) <= 1.0)).max(axis=1) + 1
    return grid, w2g, grid.instance_mask_for_aabb(np.concatenate([lo, hi]), 2), m.tf.make_world_to_grid(
        (0.1, -0.2, 0.3), 0.05, 16)


def case_integrate_without_labels(m, out):
    grid = m.tf.VoxelGrid((20, 16, 24), m.tf.make_world_to_grid((-0.5, -0.4, 0.4), 0.05, 2), 0.05)
    for K, pose, depth, _, _ in _wall_frames():
        grid.integrate(K, pose, depth)
    grid.normalize_sdfs()
    return grid


def case_scsdf_and_aabbs_io(m, out):
    rng = np.random.RandomState(3)
    sdf = rng.randn(7, 5, 6).astype(np.float32)
    sdf[0, 0, :2] = -np.inf
    m.tf.save_scsdf(os.path.join(out, "g.scsdf"), sdf, 0.05, (0.0, -1.0, 2.0), (1.0, 1.0, 3.0))
    boxes = np.array([[1, 2, 3, 4, 5, 7], [0.5, 0, 1, 2.5, 3, 3]], np.float64)
    masks = [rng.randint(0, 3, (3, 3, 4)).astype(np.uint16), rng.randint(0, 2, (2, 3, 2)).astype(np.uint16)]
    m.tf.save_aabbs(os.path.join(out, "g.aabbs"), boxes, [5, 7], masks)
    return m.tf.load_scsdf(os.path.join(out, "g.scsdf")), m.tf.load_aabbs(os.path.join(out, "g.aabbs"))


def _quads_mesh():
    """tests/test_datagen.py's two fronto-parallel quads, the nearer one
    occluding, and a large triangle (the per-face window path)."""
    verts = np.array([[-4, -4, 2], [4, -4, 2], [4, 4, 2], [-4, 4, 2], [-4, -4, 1], [0, -4, 1], [0, 4, 1],
                      [-4, 4, 1], [-1, -1, 1.5], [3, -1, 3.0], [1, 3, 2.5]], np.float64)
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7], [8, 9, 10]], np.int64)
    return verts, faces


def case_render(m, out, far=4.0):
    verts, faces = _quads_mesh()
    sem = m.mr.vertex_to_face_attr(faces, np.arange(len(verts), dtype=np.uint8) % 5 + 3)
    inst = np.array([1, 1, 2, 2, 3], np.uint16)
    colors = np.array([[200, 10, 10], [10, 200, 10], [10, 10, 200], [90, 90, 90], [255, 255, 0]], np.float64)
    w, h = 40, 30
    intr = np.array([[16.0, 0, w / 2, 0], [0, 16.0, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    pose = np.eye(4)
    pose[:3, 3] = (0.2, -0.1, -0.3)
    r = m.mr.MeshRenderer(verts, faces, sem, inst, colors=colors)
    return r.render(intr, pose, w, h, near=0.4, far=far), r.render(intr, np.eye(4), w, h, window=4, chunk=2)


def case_render_and_fuse(m, out):
    verts, faces, sem, inst = _room_mesh()
    poses = [m.vs.camera_pose(np.array([x, 1.4, 0.4]), yaw, 15.0) for x, yaw in ((1.0, 20.0), (3.0, -30.0))]
    intr = m.vs.intrinsic_from_fov(32, 24)
    return m.mr.render_and_fuse(verts, faces, sem, inst, poses, intr, 32, 24, 0.1, pad=2)


def case_isosurface(m, out):
    sdf = _sphere_sdf(16, 5.0)
    weight = np.ones_like(sdf)
    weight[:4] = 0
    sdf2 = sdf.copy()
    sdf2[8, 8, 2:6] = np.nan
    return (m.mt.extract_isosurface(sdf), m.mt.extract_isosurface(sdf2, band=3.0, weight=weight),
            m.mt.extract_isosurface(np.ones((1, 4, 4))))


def case_grid_to_mesh_and_scsdf_to_ply(m, out):
    grid, w2g = m.tf.fuse_scene(_wall_frames(), ((-0.3, -0.3, 0.5), (0.3, 0.3, 1.3)), voxel_size=0.05, pad=4)
    path = os.path.join(out, "g.scsdf")
    m.tf.save_scsdf(path, grid.sdf, 0.05, (-0.3, -0.3, 0.5), (0.3, 0.3, 1.3))
    return (m.mt.grid_to_mesh(grid), m.mt.scsdf_to_ply(path, os.path.join(out, "a.ply")),
            m.mt.scsdf_to_ply(path, os.path.join(out, "b.ply"), world_to_grid=w2g))


def _sampler_scene(m, out, n_boxes=3):
    """A 60x40x72 TSDF with boxes and masks on disk, as .scsdf/.aabbs."""
    rng = np.random.RandomState(5)
    sdf = np.full((60, 40, 72), 3.0, np.float32)
    boxes, masks = [], []
    for i in range(n_boxes):
        lo = np.array([12 + 14 * i, 16, 14 + 12 * i])
        ext = np.array([8 + 2 * i, 6, 9])
        sdf[lo[0]:lo[0] + ext[0], lo[1]:lo[1] + ext[1], lo[2]:lo[2] + ext[2]] = rng.uniform(-0.9, 0.9, ext)
        boxes.append(np.concatenate([lo, lo + ext]).astype(np.float64))
        masks.append((rng.rand(*ext) > 0.3).astype(np.uint16))
    sdf[:3] = -np.inf
    scsdf, aabbs = os.path.join(out, "s.scsdf"), os.path.join(out, "s.aabbs")
    m.tf.save_scsdf(scsdf, sdf, 0.05, (0.0, 0.0, 0.0), (3.0, 2.0, 3.6))
    m.tf.save_aabbs(aabbs, boxes, [5, 7, 39][:n_boxes], masks)
    return scsdf, aabbs, sdf, boxes, masks


def case_extract_chunk(m, out, rot=0):
    _, _, sdf, boxes, masks = _sampler_scene(m, out)
    data, sel = m.ss.extract_chunk(sdf, boxes, [5, 7, 39], masks, (6, 4, 10), rot, chunk_dim=(32, 32, 48))
    return (data, sel, m.ss.validate_chunk(sel), m.ss.rotate_mask(masks[0], rot),
            m.ss.rot_chunk_transform(m.ss.make_scene_world_to_grid((0.1, 0.0, -0.2), 0.05), sdf.shape, rot,
                                     (6, 4, 10)))


def case_find_nearest_images(m, out):
    _, _, sdf, boxes, masks = _sampler_scene(m, out)
    _, sel = m.ss.extract_chunk(sdf, boxes, [5, 7, 39], masks, (0, 0, 0), 0, chunk_dim=(60, 40, 72))
    chunk_to_world = np.linalg.inv(m.ss.make_scene_world_to_grid((0.0, 0.0, 0.0), 0.05))
    intr = m.ss.nearest_image_intrinsic()
    depths, poses = [], []
    for i, yaw in enumerate((0.0, 25.0, -20.0, 180.0)):
        pose = m.vs.camera_pose(np.array([0.3 + 0.3 * i, 0.6, -0.9]), yaw, 20.0)
        depths.append(m.mr.MeshRenderer(*_box_mesh(boxes)).render(intr, pose, 80, 60)["depth"])
        poses.append(pose)
    poses.append(np.full((4, 4), np.nan))
    depths.append(depths[0])
    return m.ss.find_nearest_images(sel, chunk_to_world, 0.05, (60, 40, 72), depths, poses, 3), intr, \
        m.ss.nearest_image_intrinsic(suncg=True)


def _box_mesh(boxes):
    """The sampler scene's boxes (grid voxels of 0.05 m from the origin) as a
    mesh in metres."""
    verts, faces = [], []
    for b in boxes:
        lo, hi = (b[:3] - 16) * 0.05, (b[3:] - 16) * 0.05  # make_scene_world_to_grid's pad of 16
        base = len(verts)
        verts.extend([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        faces.extend([[base + i for i in f] for f in ((0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
                                                      (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
                                                      (1, 5, 7), (1, 7, 3))])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def case_process_scene_files(m, out, rotate90=False):
    scsdf, aabbs, _, boxes, _ = _sampler_scene(m, out)
    depths = [np.full((60, 80), 1.5, np.float32)] * 2
    poses = [np.eye(4), np.eye(4)]
    chunks = m.ss.process_scene_chunks(scsdf, aabbs, os.path.join(out, "c_"), chunk_dim=(32, 32, 32),
                                       sample_factor=20, rotate90=rotate90, require_images=False)
    with_images = m.ss.process_scene_chunks(scsdf, aabbs, os.path.join(out, "i_"), depths=depths, poses=poses,
                                            chunk_dim=(32, 32, 32), sample_factor=20, rotate90=False,
                                            require_images=False)
    return (chunks, with_images, m.ss.process_scene(scsdf, aabbs, os.path.join(out, "s.scene")),
            m.ss.process_scene(scsdf, None, os.path.join(out, "t.scene"), generate_test_only=True))


def case_view_scoring(m, out):
    stats = m.vs.ViewStats()
    d = np.linspace(0.0, 7.0, 24 * 32).reshape(24, 32).astype(np.float32)
    s = (np.arange(24 * 32).reshape(24, 32) % 3).astype(np.uint8)
    return (m.vs.evaluate_view(d, s, stats), m.vs.compute_emd(np.arange(5.0), np.ones(5)),
            m.vs.emd_probability(0.4, 0.15, 0.15), m.vs.camera_pose(np.array([1.0, 1.5, 2.0]), 33.0, -12.0),
            m.vs.intrinsic_from_fov(48, 36, 50.0))


def case_view_generator(m, out):
    verts, faces, sem, inst = _room_mesh()
    gen = m.vs.ViewGenerator(m.mr.MeshRenderer(verts, faces, sem, inst), 32, 24, seed=7)
    keys = gen.generate_keys(max_samples=16)
    return keys, gen.interpolate_trajectory(keys, max_views=30), gen.rng.get_state()[1]


def case_virtual_scan(m, out):
    verts, faces, sem, inst = _room_mesh()
    return m.vs.virtual_scan(verts, faces, sem, inst, voxel_size=0.2, width=24, height=18, seed=3, max_views=12)


def case_room_mesh(m, out):
    rng = np.random.RandomState(9)
    return (m.sc.room_mesh(rng, (5.0, 2.4, 4.0), 7), rng.get_state()[1],
            m.sc.scaled_intrinsic(m.vs.intrinsic_from_fov(328, 256), (328, 256), (41, 32)))


def case_generate_scene(m, out):
    """tests/test_color_loop.py's tiny settings: the whole loop's file tree."""
    rng = np.random.RandomState(0)
    res = m.sc.generate_scene(rng, out, "cl0", extent_m=(4.0, 2.2, 4.0), n_objects=5, voxel_size=0.1,
                              image_wh=(64, 48), max_views=20, traj_wh=(48, 36), sample_factor=24,
                              chunk_dim=(32, 32, 32))
    assert res["chunk_paths"]
    return res, rng.get_state()[1]


def case_export_frames(m, out):
    from PIL import Image

    rng = np.random.RandomState(2)
    frames = []
    for i in range(5):
        pose = np.eye(4, dtype=np.float32)
        pose[2, 3] = float(i)
        frames.append((pose, rng.randint(0, 255, (24, 32, 3)).astype(np.uint8),
                       (rng.rand(12, 16) * 4000).astype(np.uint16)))
    sens = os.path.join(out, "scene.sens")
    _write_sens(sens, frames)
    label_dir = os.path.join(out, "label-filt")
    os.makedirs(label_dir)
    for i in range(5):
        Image.fromarray(rng.choice([0, 3, 7, 1200], size=(24, 32)).astype(np.uint16)).save(
            os.path.join(label_dir, f"{i}.png"))
    tsv = os.path.join(out, "labels.combined.tsv")
    with open(tsv, "w") as f:
        f.write("id\traw_category\tnyu40id\n3\tchair\t5\n7\ttable\t39\n1200\tcustom\t\n")
    mapping = m.p2.read_scannet_label_mapping(tsv)
    m.p2.export_frames(sens, os.path.join(out, "frames"), frame_skip=2, image_size=(16, 12), label_dir=label_dir,
                       label_mapping=mapping)
    reader = m.p2.SensFile(sens)
    try:
        header = {k: v for k, v in vars(reader).items() if k not in ("file", "path")}
        return header, reader.read_frame(3), mapping, m.p2.map_label_image(np.array([[3, 9], [1200, 7]]), mapping)
    finally:
        reader.close()


CASES = [
    ("fuse_scene", case_fuse_scene, {}),
    ("integrate_without_labels", case_integrate_without_labels, {}),
    ("scsdf_and_aabbs_io", case_scsdf_and_aabbs_io, {}),
    ("render", case_render, {"far": 4.0}),
    ("render_culled", case_render, {"far": 0.9}),
    ("render_and_fuse", case_render_and_fuse, {}),
    ("isosurface", case_isosurface, {}),
    ("grid_to_mesh_and_scsdf_to_ply", case_grid_to_mesh_and_scsdf_to_ply, {}),
    *[(f"extract_chunk_rot{r}", case_extract_chunk, {"rot": r}) for r in range(4)],
    ("find_nearest_images", case_find_nearest_images, {}),
    ("process_scene_files", case_process_scene_files, {"rotate90": False}),
    ("process_scene_files_rotated", case_process_scene_files, {"rotate90": True}),
    ("view_scoring", case_view_scoring, {}),
    ("view_generator", case_view_generator, {}),
    ("virtual_scan", case_virtual_scan, {}),
    ("room_mesh", case_room_mesh, {}),
    ("generate_scene", case_generate_scene, {}),
    ("export_frames", case_export_frames, {}),
]


@pytest.mark.parametrize("fn,kwargs", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_datagen_matches_jax(tmp_path, fn, kwargs):
    outs = {}
    for name, pkg in PACKAGES.items():
        out = str(tmp_path / name)
        os.makedirs(out)
        outs[name] = fn(pkg, out, **kwargs)
    _same(outs["port"], outs["jax"], str(tmp_path / "port"), str(tmp_path / "jax"))
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
