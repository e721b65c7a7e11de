"""The port's publish (`fastvocoder_tpu_torch/bin/publish.py`,
`train/checkpoint.py::save_published`) on the CPU against the JAX
package's, on a narrow Basis-MelGAN trained one step by the port and saved
in the reference layout:

  * the pattern (the zero-mel response, 64 frames here; the 30,000 of
    `PATTERN_FRAMES` run on the card) within 1e-5 of the peak of the
    pattern JAX's `publish_model` computes from the same checkpoint;
  * a port-published file loads in JAX's `load_checkpoint`: the same
    generator tree as the training checkpoint's, the same pattern; and a
    JAX-published file loads in the port's `load_generator`, its pattern
    included, and synthesizes within 1e-4 of the JAX generator's peak;
  * another family (HiFiGAN) is published with an empty pattern, which
    `load_generator` reads as None.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu.bin.publish import publish_model as jax_publish_model
from fastvocoder_tpu.models.factory import build_generator as jax_build_generator
from fastvocoder_tpu.train import checkpoint as jck
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.bin.publish import PATTERN_FRAMES, publish_model, run_publisher
from fastvocoder_tpu_torch.checkpoint import checkpoint_format
from fastvocoder_tpu_torch.models.factory import load_generator
from fastvocoder_tpu_torch.train import checkpoint as tck
from fastvocoder_tpu_torch.train.trainer import make_trainer

BASIS_YAML = (
    "L: 30\nin_channels: 80\nout_channels: 16\nkernel_size: 7\nchannels: [16, 16, 16]\n"
    "upsample_scales: [4, 4]\nstack_kernel_size: 3\nstacks: 3\nuse_weight_norm: True\n"
    "use_causal_conv: False\ntransposedconv: True\nbias: True\nlamda_stft: 1.0\n"
)
HIFI_YAML = (
    "resblock_kernel_sizes: [3, 5]\nupsample_rates: [8, 5, 3, 2]\n"
    "upsample_initial_channel: 32\nresblock_type: '1'\n"
    "upsample_kernel_sizes: [16, 10, 6, 4]\nresblock_dilation_sizes: [[1, 3], [1, 3]]\n"
    "transposedconv: True\nbias: True\nmultiband: False\nlamda_stft: 5.0\n"
)
FRAMES = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(config path, checkpoint path) of a narrow Basis-MelGAN after one
    port pre-adversarial step, in the reference layout."""
    root = tmp_path_factory.mktemp("publish")
    conf = root / "basis.yaml"
    conf.write_text(BASIS_YAML)
    rng = np.random.default_rng(0)
    basis = (0.1 * rng.standard_normal((30, 16))).astype(np.float32)
    tr = make_trainer(thp.load_model_config("basis-melgan", str(conf)),
                      hp=thp.HP.replace(fixed_length=10), basis_signal_weight=basis,
                      disc_cfg=thp.TINY_DISC, device="cpu")
    state = tr.init_state(0)
    mel = rng.standard_normal((2, 10, 80)).astype(np.float32)
    wav = (0.3 * np.sin(np.arange(2 * 2400) / 7.0)).reshape(2, 2400).astype(np.float32)
    weight = rng.random((2, 160, 16)).astype(np.float32)
    tr.pre_adv_step(state, *(torch.from_numpy(a) for a in (mel, wav, weight)))
    path = str(root / "checkpoint_1.pth.tar")
    tck.save_checkpoint(path, state, "basis-melgan")
    return str(conf), path


def test_publish_pattern_is_jaxs_and_files_cross(trained, tmp_path):
    conf, ckpt = trained
    port_file, jax_file = str(tmp_path / "port.pth.tar"), str(tmp_path / "jax.pth.tar")
    pattern = publish_model(ckpt, conf, "basis-melgan", port_file, pattern_frames=FRAMES,
                            device="cpu")
    jax_publish_model(ckpt, conf, "basis-melgan", jax_file, pattern_frames=FRAMES)
    assert checkpoint_format(port_file) == checkpoint_format(jax_file) == "reference"

    jcfg = jhp.load_model_config("basis-melgan", conf)
    from_jax = jck.load_checkpoint(jax_file, jcfg, with_discriminator=False)
    want = np.asarray(from_jax["pattern"])
    assert pattern.shape == want.shape == ((FRAMES * 16 - 1) * 15 + 30,)
    assert np.abs(pattern - want).max() <= 1e-5 * np.abs(want).max()

    # the port's file in JAX: the checkpoint's generator, the same pattern
    from_port = jck.load_checkpoint(port_file, jcfg, with_discriminator=False)
    source = jck.load_checkpoint(ckpt, jcfg, with_discriminator=False)
    assert jax.tree_util.tree_structure(from_port["gen_params"]) == \
        jax.tree_util.tree_structure(source["gen_params"])
    for a, b in zip(jax.tree_util.tree_leaves(from_port["gen_params"]),
                    jax.tree_util.tree_leaves(source["gen_params"])):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(from_port["pattern"]), pattern)

    # JAX's file in the port: its pattern, and what its generator computes
    gen, got_pattern = load_generator(jax_file, thp.load_model_config("basis-melgan", conf),
                                      torch.device("cpu"))
    assert np.array_equal(got_pattern, want.astype(np.float32))
    mel = np.random.default_rng(5).standard_normal((1, 23, 80)).astype(np.float32)
    jgen = jax_build_generator(jcfg, weight_norm=True)
    want_wav = np.asarray(jgen.apply({"params": from_jax["gen_params"]}, jnp.asarray(mel),
                                     method=jgen.inference))
    with torch.inference_mode():
        got_wav = gen.inference(torch.from_numpy(mel)).numpy()
    assert got_wav.shape == want_wav.shape
    assert np.abs(got_wav - want_wav).max() <= 1e-4 * np.abs(want_wav).max()


def test_other_families_publish_an_empty_pattern(tmp_path):
    conf = tmp_path / "hifigan.yaml"
    conf.write_text(HIFI_YAML)
    cfg = thp.load_model_config("hifigan", str(conf))
    state = make_trainer(cfg, disc_cfg=thp.TINY_DISC, device="cpu").init_state(0)
    ckpt = str(tmp_path / "checkpoint_0.pth.tar")
    tck.save_checkpoint(ckpt, state, "hifigan")
    out = str(tmp_path / "published.pth.tar")
    pattern = run_publisher(["--checkpoint_path", ckpt, "--model_name", "hifigan",
                             "--config", str(conf), "--save_path", out, "--device", "cpu"])
    assert pattern.shape == (0,) and PATTERN_FRAMES == 30000
    gen, got = load_generator(out, cfg, torch.device("cpu"))
    assert got is None
    jcfg = jhp.load_model_config("hifigan", str(conf))
    assert np.asarray(jck.load_checkpoint(out, jcfg, with_discriminator=False)["pattern"]).size == 0
    with pytest.raises(ValueError, match="release checkpoint"):
        publish_model("docs/checkpoints/hifigan_light_clean2.npz", str(conf), "hifigan",
                      str(tmp_path / "x.pth.tar"), device="cpu")


def test_release_pattern_is_the_zero_mel_response_of_its_weights():
    """`basis_melgan_clean2.npz` stores its pattern and its weights in
    float16; the pattern was computed from the weights before they were
    rounded.  The zero-mel response of the committed weights, over the first
    150 of 200 frames, lies within 5e-4 of the pattern's peak of it in both
    packages, the port's as close as JAX's to within 1e-5 of the peak.  chip_smoke.py holds the
    card's response over 3,000 frames by the same rule."""
    from fastvocoder_tpu.models.factory import build_generator as jax_build
    from fastvocoder_tpu.train.checkpoint import fuse_weight_norm
    from fastvocoder_tpu_torch.bin.publish import zero_mel_response
    from test_torch_evaluation import CONF, NPZ, release_tree

    _, tree, stored = release_tree(NPZ)
    stored = stored[: 150 * 240]
    peak = np.abs(stored).max()
    gen, _ = load_generator(NPZ, thp.load_model_config("basis-melgan", CONF), torch.device("cpu"))
    got = zero_mel_response(gen, 200, 80, torch.device("cpu"))[: 150 * 240]
    jgen = jax_build(jhp.load_model_config("basis-melgan", CONF), weight_norm=False)
    want = np.asarray(jgen.apply({"params": fuse_weight_norm(tree)}, jnp.zeros((1, 200, 80)),
                                 method=jgen.inference))[0, : 150 * 240]
    port_err, jax_err = np.abs(got - stored).max(), np.abs(want - stored).max()
    assert jax_err <= 5e-4 * peak and port_err <= 5e-4 * peak
    assert port_err <= jax_err + 1e-5 * peak
