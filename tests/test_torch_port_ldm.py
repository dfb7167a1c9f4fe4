"""Port latent stack (the dynamic LDM hint encoder of
controlnet_tpu_torch.models.controlnet, controlnet_tpu_torch.models.vae, the
latent ControlNet forward, and their weight carry-over) against the JAX
package, on the same numpy weights and inputs.

JAX runs on the CPU in float32 matmul precision (tests/conftest.py); its
hint encoder takes the transposed-layout route with the XLA einsum convs
(the Pallas kernel is TPU-only and is held against the port in
test_torch_port_tl_conv.py).  The port runs on the CPU, where its conv and
attention kernels take their plain versions.  Tolerance: atol 1e-4 on
outputs of magnitude ~1 (dozens of float32 convolutions summed in another
order by each framework); 2e-5 for the hint encoder alone.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import NARROW_LDM, Z, random_params, to_nchw, to_nhwc
from controlnet_tpu.io.torch_export import export_controlnet, export_vae
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.vae import VAE as JaxVAE
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet, _dynamic_hint_block
from controlnet_tpu_torch.models.vae import VAE
from controlnet_tpu_torch.ops import cuda_attention, tl_conv

ATOL = 1e-4

def _nchw_contiguous(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_nhwc).transpose(0, 3, 1, 2)))


def _carried(factor, seed, cfg=NARROW_LDM):
    jcn = JaxControlNet(Z, cfg, down_sample_factor=factor)
    p = random_params(jcn, seed)
    cn = ControlNet(Z, cfg, down_sample_factor=factor)
    cn.load_state_dict(jax_params.controlnet_state_dict_from_jax(p, ldm=True), strict=True)
    return jcn, p, cn.eval()


@pytest.fixture
def conv3x3_calls(monkeypatch):
    """Counts calls at the dispatch point of kernel c (each one is a launch
    on a CUDA tensor)."""
    calls = []
    orig = tl_conv.conv3x3_tl

    def spy(weight, bias, x, hw):
        calls.append((x.shape[0], weight.shape[0], tuple(hw)))
        return orig(weight, bias, x, hw)

    monkeypatch.setattr(tl_conv, "conv3x3_tl", spy)
    return calls


@pytest.mark.parametrize("factor", [4, 8])
def test_dynamic_hint_block_matches_jax_and_nchw_route(factor, conv3x3_calls):
    """hint 64^2: the TL route against the JAX ``hint_features`` and against
    the port's own NCHW route (the same modules through ``F.conv2d``)."""
    jcn, p, cn = _carried(factor, 10 + factor)
    hint = np.random.default_rng(factor).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jcn.hint_features)(p, jnp.asarray(hint)))
    with torch.no_grad():
        out = cn.hint_features(_nchw_contiguous(hint))
        nchw = cn.hint_block(_nchw_contiguous(hint))
    size = 64 // factor
    assert out.shape == (2, 16, size, size) and out.is_contiguous()
    np.testing.assert_allclose(to_nhwc(out), ref, atol=2e-5)
    torch.testing.assert_close(out, nchw, rtol=0, atol=2e-5)
    # stem + one per stride-2 stage + the last stage's first conv
    n_stages = factor.bit_length() - 1
    assert len(conv3x3_calls) == n_stages + 2
    assert conv3x3_calls[0] == (3, 16, (64, 64))
    assert conv3x3_calls[-1] == (16 * factor, 16, (size, size))


def test_hint_encode_at_factor_32_makes_7_conv_kernel_calls(conv3x3_calls):
    """The CelebA-HQ factor (1024 / 32): seven stride-1 3x3 convs per encode,
    every one through the kernel's dispatch point, the 3 -> 16 stem too.
    chip_smoke.py holds the kernel's launch counter to the same 7 per chunk."""
    cn = ControlNet(Z, NARROW_LDM, down_sample_factor=32).eval()
    with torch.no_grad():
        out = cn.hint_features(torch.zeros(1, 3, 64, 64))
    assert out.shape == (1, 16, 2, 2)
    assert [(c[0], c[1]) for c in conv3x3_calls] == [
        (3, 16), (32, 32), (64, 64), (128, 128), (256, 256), (512, 512), (512, 16)]
    assert [c[2][0] for c in conv3x3_calls] == [64, 32, 16, 8, 4, 2, 2]


def test_hint_features_chunked_is_bit_identical(conv3x3_calls):
    """The encoder has no cross-batch operation, so chunking changes nothing
    where the convolutions are batch-invariant: bit-identical with PyTorch's
    native CPU convolution.  oneDNN picks its algorithm by batch size, so
    with it the results agree to float32 rounding only (1e-6)."""
    _, _, cn = _carried(4, 3)
    hint = torch.from_numpy(np.random.default_rng(3).uniform(size=(5, 3, 16, 16))
                            .astype(np.float32))
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        whole = cn.hint_features(hint)
        del conv3x3_calls[:]
        chunked = cn.hint_features_chunked(hint, chunk=2)
        assert len(conv3x3_calls) == 3 * 4  # 3 chunks of 4 convs
        single = cn.hint_features_chunked(hint, chunk=8)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    torch.testing.assert_close(single, whole, rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(cn.hint_features_chunked(hint, chunk=2),
                                   cn.hint_features(hint), rtol=0, atol=1e-6)


@pytest.mark.parametrize("factor", [0, 3, 12])
def test_non_power_of_two_factor_raises(factor):
    with pytest.raises(ValueError, match="power of two"):
        _dynamic_hint_block(3, 16, factor)
    with pytest.raises(ValueError, match="power of two"):
        ControlNet(Z, NARROW_LDM, down_sample_factor=factor)


def test_tl_forward_rejects_what_it_has_no_route_for():
    from controlnet_tpu_torch.nn.layers import Conv2d, Sequential

    x = torch.zeros(4, 1, 64)
    with pytest.raises(ValueError, match="no transposed-layout forward for a conv"):
        Conv2d(4, 4, 4, stride=2, padding=1).tl(x, (8, 8))
    with pytest.raises(ValueError, match="no transposed-layout forward for Tanh"):
        Sequential(Conv2d(4, 4, 3), torch.nn.Tanh()).tl(x, (8, 8))


def test_hint_features_needs_rows_of_pixels_contiguous():
    """A channels-last hint is refused rather than copied behind the caller's back."""
    cn = ControlNet(Z, NARROW_LDM, down_sample_factor=4).eval()
    hint = torch.zeros(1, 16, 16, 3).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="contiguous rows"):
        cn.hint_features(hint)


def _carried_vae(cfg, seed):
    jvae = JaxVAE(3, cfg)
    p = random_params(jvae, seed)
    vae = VAE(3, cfg)
    vae.load_state_dict(jax_params.vae_state_dict_from_jax(p), strict=True)
    return jvae, p, vae.eval()


def test_vae_matches_jax(tiny_vae_config):
    jvae, p, vae = _carried_vae(tiny_vae_config, 20)
    rng = np.random.default_rng(20)
    x = rng.uniform(-1, 1, size=(2, 8, 8, 3)).astype(np.float32)
    z = rng.standard_normal((2, 4, 4, 2)).astype(np.float32)
    ref_enc = np.asarray(jax.jit(jvae.moments)(p, jnp.asarray(x)))
    ref_dec = np.asarray(jax.jit(jvae.decode)(p, jnp.asarray(z)))
    with torch.no_grad():
        enc = vae.moments(to_nchw(x))
        dec = vae.decode(to_nchw(z))
    assert enc.shape == (2, 4, 4, 4) and dec.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(to_nhwc(enc), ref_enc, atol=ATOL)
    np.testing.assert_allclose(to_nhwc(dec), ref_dec, atol=ATOL)


def test_vae_encode_and_forward_with_injected_noise(tiny_vae_config):
    """The reparameterized sample with the JAX draw handed to the port."""
    jvae, p, vae = _carried_vae(tiny_vae_config, 21)
    x = np.random.default_rng(21).uniform(-1, 1, size=(2, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (2, 4, 4, 2), jnp.float32))
    ref_out, ref_enc = jax.jit(jvae.__call__)(p, jnp.asarray(x), key)
    ref_z, _ = jvae.encode(p, jnp.asarray(x), key)
    with torch.no_grad():
        z, enc = vae.encode(to_nchw(x), noise=to_nchw(noise))
        out, enc2 = vae(to_nchw(x), noise=to_nchw(noise))
        drawn, _ = vae.encode(to_nchw(x), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(to_nhwc(z), np.asarray(ref_z), atol=ATOL)
    np.testing.assert_allclose(to_nhwc(enc), np.asarray(ref_enc), atol=ATOL)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref_out), atol=ATOL)
    torch.testing.assert_close(enc2, enc, rtol=0, atol=0)
    assert drawn.shape == z.shape and not torch.equal(drawn, z)


def test_latent_controlnet_forward_matches_jax():
    """Narrow LDM config, latents 8x8, hints 32x32 (factor 4): the forward
    from raw hints and from precomputed hint features."""
    jcn, p, cn = _carried(4, 30)
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 8, 8, Z)).astype(np.float32)
    hint = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    t = rng.integers(0, 1000, size=(2,))
    ref = np.asarray(jax.jit(jcn.__call__)(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(hint)))
    with torch.no_grad():
        out = cn(to_nchw(x), torch.from_numpy(t), _nchw_contiguous(hint))
        feats = cn.hint_features_chunked(_nchw_contiguous(hint), chunk=1)
        out_f = cn(to_nchw(x), torch.from_numpy(t), hint_features=feats)
    assert out.shape == (2, Z, 8, 8)
    np.testing.assert_allclose(to_nhwc(out), ref, atol=ATOL)
    torch.testing.assert_close(out_f, out, rtol=0, atol=1e-6)  # chunk 1: oneDNN's choice


def test_latent_forward_makes_22_attention_calls(monkeypatch):
    """config/celebhq.yaml's structure (2 layers per block, latents 32x32) at
    a quarter of its widths: 22 attention calls per ControlNet forward (trunk:
    6 down + 2 mid + 6 up; control copy: 6 down + 2 mid), at the full
    config's token counts.  chip_smoke.py holds the kernel's launch counter
    to the same 22 at the full width."""
    cfg = dict(NARROW_LDM, down_channels=[64, 96, 128, 192], mid_channels=[192, 128],
               conv_out_channels=32, num_down_layers=2, num_mid_layers=2, num_up_layers=2,
               norm_channels=32, num_heads=16)
    calls = collections.Counter()
    orig = cuda_attention.fused_attention_t

    def spy(qt, kt, vt):
        calls[(qt.shape[3], qt.shape[2])] += 1
        return orig(qt, kt, vt)

    monkeypatch.setattr(cuda_attention, "fused_attention_t", spy)
    cn = ControlNet(4, cfg, down_sample_factor=2).eval()
    with torch.no_grad():
        cn(torch.zeros(1, 4, 32, 32), torch.tensor([5]), torch.zeros(1, 3, 64, 64))
    # (tokens, head_dim): head dims are a quarter of the full config's 24/32/48/32/24/16/8
    assert calls == {(1024, 6): 4, (256, 8): 4, (64, 12): 4, (16, 8): 4,
                     (64, 6): 2, (256, 4): 2, (1024, 2): 2}
    assert sum(calls.values()) == 22


def _assert_same(sd, ref):
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_vae_state_dict_matches_export_vae(tiny_vae_config):
    jvae = JaxVAE(3, tiny_vae_config)
    p = random_params(jvae, 40)
    sd = jax_params.vae_state_dict_from_jax(p)
    _assert_same(sd, export_vae(p))
    vae = VAE(3, tiny_vae_config)
    vae.load_state_dict(sd, strict=True)
    assert set(vae.state_dict()) == set(sd)


@pytest.mark.parametrize("factor", [2, 8])
def test_ldm_controlnet_state_dict_matches_export_controlnet(factor):
    jcn = JaxControlNet(Z, NARROW_LDM, down_sample_factor=factor)
    p = random_params(jcn, 41)
    sd = jax_params.controlnet_state_dict_from_jax(p, ldm=True)
    _assert_same(sd, export_controlnet(p, jcn))
    cn = ControlNet(Z, NARROW_LDM, down_sample_factor=factor)
    cn.load_state_dict(sd, strict=True)
    assert set(cn.state_dict()) == set(sd)
    n_stages = factor.bit_length() + 1  # stem + stride-2 stages + last
    assert f"control_unet_hint_block.{n_stages - 1}.2.weight" in sd
    assert len(cn.zero_convs()) == 3 + 1 + 1 and cn.zero_convs()[-1] is cn.hint_block[-1][-1]
