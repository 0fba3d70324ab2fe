"""The inputs every run makes from its seed, on the device, in few calls:
a masked Tanks-and-Temples-like scene (a statue of fixed shape inside the
unit box, white background, cameras on a ring around it, 1920x1080
views), the held-out rays, and the initial weights.

The scene (geometry, colours, cameras, image size) is the same for every
seed, so every seed asks the same work of the march and sets the same
task, and so are the held-out pixels; the seed sets the weights and the
order of the rays.
"""

from __future__ import annotations

import math

import torch

# the statue, in the normalised scene ([-0.5, 0.5]^3, z up): ellipsoids
# (centre, radii) on a box pedestal
ELLIPSOIDS = (
    ((0.0, 0.0, -0.02), (0.15, 0.12, 0.22)),      # body
    ((0.0, 0.0, 0.25), (0.09, 0.09, 0.09)),       # head
    ((0.14, 0.02, 0.06), (0.17, 0.05, 0.05)),     # arm
    ((-0.06, 0.0, -0.22), (0.07, 0.07, 0.08)),    # leg
)
PEDESTAL = ((0.0, 0.0, -0.36), (0.24, 0.24, 0.08))
LIGHT = (0.4, -0.5, 0.77)


def view_poses(n: int, radius: float, device, phase: float = 0.0):
    """(n, 3, 4) camera-to-world poses (columns right, down, forward,
    centre) on a ring of `radius` at elevations between 5 and 35
    degrees, all looking at the origin."""
    i = torch.arange(n, dtype=torch.float64)
    az = 2 * math.pi * (i + phase) / n
    el = math.radians(5.0) + math.radians(30.0) * (
        (i * 0.618034 + phase) % 1.0)
    eye = radius * torch.stack([torch.cos(el) * torch.cos(az),
                                torch.cos(el) * torch.sin(az),
                                torch.sin(el)], -1)
    fwd = -eye / eye.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64).expand_as(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / right.norm(dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    pose = torch.stack([right, down, fwd, eye], -1)
    return pose.float().to(device)


def directions(w: int, h: int, focal: float, device) -> torch.Tensor:
    """Pixel-centre camera-frame directions (h w, 3), row-major, [right
    down forward], not normalised (NSVF's convention)."""
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    d = torch.stack([(u - w / 2 + 0.5) / focal, (v - h / 2 + 0.5) / focal,
                     torch.ones_like(u)], -1)
    return d.reshape(-1, 3)


def _hit_ellipsoid(o, d, c, r):
    """Nearest t >= 0 where rays hit the ellipsoid, inf on a miss."""
    c = torch.tensor(c, device=o.device)
    r = torch.tensor(r, device=o.device)
    oc, dd = (o - c) / r, d / r
    a = (dd * dd).sum(-1)
    b = (oc * dd).sum(-1)
    cc = (oc * oc).sum(-1) - 1.0
    disc = b * b - a * cc
    s = torch.sqrt(disc.clamp_min(0.0))
    t = (-b - s) / a
    t = torch.where(t < 0, (-b + s) / a, t)
    return torch.where((disc >= 0) & (t >= 0), t, torch.inf)


def _hit_box(o, d, c, h):
    c = torch.tensor(c, device=o.device)
    h = torch.tensor(h, device=o.device)
    inv = 1.0 / d
    t0, t1 = (c - h - o) * inv, (c + h - o) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    t = torch.where(tn >= 0, tn, tf)
    return torch.where((tf >= tn) & (t >= 0), t, torch.inf)


def shade(o: torch.Tensor, d: torch.Tensor, tex: torch.Tensor):
    """Colour of rays (N, 3) against the statue: a textured Lambertian
    surface lit from LIGHT, white where a ray misses it. `tex` (3, 3)
    holds the base colour, the stripes' direction and their phases."""
    ts = [_hit_ellipsoid(o, d, c, r) for c, r in ELLIPSOIDS]
    ts.append(_hit_box(o, d, *PEDESTAL))
    t_all = torch.stack(ts)
    t, which = t_all.min(0)
    hit = torch.isfinite(t)
    p = o + d * torch.where(hit, t, 0.0)[:, None]
    # the normal: of the hit ellipsoid, or the box's dominant face
    n = torch.zeros_like(p)
    for k, (c, r) in enumerate(ELLIPSOIDS):
        c = torch.tensor(c, device=o.device)
        r = torch.tensor(r, device=o.device)
        nk = (p - c) / (r * r)
        n = torch.where((which == k)[:, None], nk, n)
    c, h = (torch.tensor(v, device=o.device) for v in PEDESTAL)
    q = (p - c) / h
    nb = torch.zeros_like(q).scatter(1, q.abs().argmax(1, keepdim=True), 1.0)
    nb = nb * torch.sign(q)
    n = torch.where((which == len(ELLIPSOIDS))[:, None], nb, n)
    n = n / n.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    light = torch.tensor(LIGHT, device=o.device)
    light = light / light.norm()
    lam = 0.35 + 0.65 * (n * light).sum(-1).clamp_min(0.0)
    stripes = 0.5 + 0.5 * torch.sin(
        (p @ (tex[1] * 40.0))[:, None] + tex[2][None] * 6.283)
    albedo = tex[0][None] * (0.55 + 0.45 * stripes)
    rgb = (albedo * lam[:, None]).clamp(0.0, 1.0)
    return torch.where(hit[:, None], rgb, 1.0)


VIEWS_A_CALL = 8
TEXTURE = ((0.78, 0.52, 0.33), (0.31, -0.62, 0.45), (0.12, 0.57, -0.81))


def make_scene(sc: dict, device, images: bool = True) -> dict:
    """The ray store of the training views (images (n, h w, 3) f32, poses
    (n, 3, 4), directions (h w, 3)) and the held-out views' poses;
    without `images`, no training image."""
    tex = torch.tensor(TEXTURE, device=device)
    w, h = sc["img_wh"]
    dirs = directions(w, h, sc["focal"], device)
    poses = view_poses(sc["n_train_views"], sc["camera_radius"], device)
    test = view_poses(sc["n_test_views"], sc["camera_radius"], device,
                      phase=0.5)
    images = torch.empty((len(poses) if images else 0, w * h, 3),
                         device=device)
    for i in range(0, len(images), VIEWS_A_CALL):
        pose = poses[i:i + VIEWS_A_CALL]
        n = len(pose)
        o = pose[:, None, :, 3].expand(n, w * h, 3).reshape(-1, 3)
        d = torch.einsum("pj,vij->vpi", dirs, pose[:, :, :3]).reshape(-1, 3)
        images[i:i + n] = shade(o, d, tex).reshape(n, w * h, 3)
    return {"images": images, "poses": poses, "directions": dirs,
            "test_poses": test, "tex": tex}


def held_out_rays(scene: dict, n: int, seed: int = 0):
    """`n` pixels of the held-out views drawn from `seed` (the same set
    for every run): (view, pixel) indices, origins, directions and the
    true colours."""
    dev = scene["directions"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pix = scene["directions"].shape[0]
    view = torch.randint(0, len(scene["test_poses"]), (n,), generator=gen,
                         device=dev)
    pix = torch.randint(0, n_pix, (n,), generator=gen, device=dev)
    pose = scene["test_poses"][view]
    dirs = scene["directions"][pix]
    d = (dirs[:, 0:1] * pose[:, :, 0] + dirs[:, 1:2] * pose[:, :, 1]
         + dirs[:, 2:3] * pose[:, :, 2])
    o = pose[:, :, 3].contiguous()
    return {"view": view, "pix": pix, "o": o, "d": d,
            "rgb": shade(o, d, scene["tex"])}


def make_weights(spec: list, seed: int, device) -> dict:
    """The initial weights {path: tensor} of a parameter spec [(path,
    shape, init, arg)]: init "uniform" draws U(-arg, arg), "he" He-uniform
    over the fan-in (shape[-2]) times arg, "first" is zero but arg in the
    first entry of the last axis; one draw per leaf from a generator on
    the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for path, shape, init, arg in spec:
        if init == "first":
            out[path] = torch.zeros(shape, device=device)
            out[path][..., 0] = float(arg)
            continue
        u = torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0
        bound = arg if init == "uniform" else arg * math.sqrt(6.0 / shape[-2])
        out[path] = u * bound
    return out


def statue_occupancy(grid: int, scale: float, n_experts: int, device,
                     margin: float = 0.02, overlap: float = 0.05):
    """(n_experts, grid^3) bool: the cells whose centre lies within
    `margin` of the statue, split between the experts along x in slabs
    that overlap by `overlap` (expert k holds the k-th slab)."""
    r = (torch.arange(grid, device=device, dtype=torch.float32) + 0.5
         ) / grid * 2 * scale - scale
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    p = torch.stack([x, y, z], -1).reshape(-1, 3)
    inside = torch.zeros(p.shape[0], dtype=torch.bool, device=device)
    for c, rad in ELLIPSOIDS:
        c = torch.tensor(c, device=device)
        rad = torch.tensor(rad, device=device) + margin
        inside |= (((p - c) / rad) ** 2).sum(-1) <= 1.0
    c, h = (torch.tensor(v, device=device) for v in PEDESTAL)
    inside |= ((p - c).abs() <= h + margin).all(-1)
    edges = torch.linspace(-scale, scale, n_experts + 1, device=device)
    return torch.stack([inside & (p[:, 0] >= edges[k] - overlap)
                        & (p[:, 0] <= edges[k + 1] + overlap)
                        for k in range(n_experts)])
