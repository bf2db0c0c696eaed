"""rgb2cam and rgb2gaze on the port against the JAX package, on the CPU.

* Greedy ROAR with CFG 2.0 through GenerationSampler, on the tiny registry
  model with weights carried from JAX, a 256-token rgb grid (the encoder on
  flash64: the JAX kernel in interpret mode, the port's plain version) and
  the released 30-token, 256-code cam and gaze targets, in the tasks' 3 and
  5 steps: the same positions are chosen, and the port's tokens are the
  argmax of the JAX logits at the same ids_keep wherever the top-1 / top-2
  gap is clear (the method of test_torch_generate.py).
* eval_common's task table and schedules against the JAX entry points',
  the npz reader, which tokenizers each task loads, and the refusals: no
  CUDA device under the default --device, a missing tokenizer checkpoint
  without --smoke.

The entry points' full 5120-token runs are tests/test_torch_eval_seq_entry.py.
"""
import copy
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import egom2p_tpu.generate.sampler as jsampler
import egom2p_tpu.ops.flash_attention as jax_fa
from egom2p_torch.cli import eval_common, eval_model_rgb2cam, eval_model_rgb2gaze
from egom2p_torch.compat.from_jax import egom2p_state_dict_from_jax
from egom2p_torch.data.modality_info import MODALITY_INFO
from egom2p_torch.generate import sampler as tsampler
from egom2p_torch.models.egom2p import create_model
from egom2p_torch.ops.attention import inference_attention
from egom2p_tpu.generate import schedules as jsched
from egom2p_tpu.models.egom2p import create_model as jax_create_model

from test_torch_generate import (_jax_step_logits, exact_topk,  # noqa: F401
                                 fresh_xla_programs, jax_flash)
from test_torch_model import MODS4, NAME, make_mod_dict, tiny_info, to_jax
from test_torch_seq_vqvae import SMALL

torch.set_num_threads(2)

TINY = "egom2p_tiny_6e_6d_swiglu_nobias"
# fp32 logits of the CFG-mixed decoder states (encoder on flash64, whose
# bf16 roundings of q/k/v and p flip with the order of fp32 sums): 1.23e-3
# max observed over both tasks' steps
LOGITS_ATOL = 2.5e-3
GAP = 10 * LOGITS_ATOL  # tokens are compared where the JAX top-1/top-2 gap exceeds this


@pytest.fixture(scope="module")
def models():
    """The tiny model over a 256-token rgb / depth grid and the released
    cam / gaze modalities (30 tokens of 256 codes), JAX and port, with the
    same weights."""
    info = tiny_info((2, 8, 16))
    for m in ("tok_cam", "tok_gaze"):
        info[m] = copy.deepcopy(MODALITY_INFO[m])
    jmodel = jax_create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32")
    with mock.patch.object(jax_fa, "supports_flash", lambda: False):  # init runs training
        params = jmodel.init(jax.random.PRNGKey(0),
                             to_jax(make_mod_dict(np.random.default_rng(1), info)), 16, 16)
    tmodel = create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32")
    tmodel.load_state_dict(egom2p_state_dict_from_jax(params, tmodel))
    return info, jmodel, params, tmodel.eval()


@pytest.mark.parametrize("task", ["rgb2cam", "rgb2gaze"])
def test_greedy_roar_cfg_matches_jax(models, exact_topk, jax_flash, fresh_xla_programs, task):
    info, jmodel, params, tmodel = models
    t = eval_common.TASKS[task]
    L = info[t.target]["max_tokens"]
    rgb = info["tok_rgb"]["max_tokens"]
    md = {"tok_rgb": {"tensor": np.random.default_rng(0).integers(0, 96, (2, rgb)).astype(np.int32)}}
    jsampler.init_full_input_modality(md, info, "tok_rgb")
    jsampler.init_empty_target_modality(md, info, t.target, 2, L)
    schedule = eval_common.roar_schedule(t.cond, t.target, t.steps, temperature=0.0)
    assert [s["num_tokens"] for s in schedule] == [L // t.steps] * t.steps
    js = jsampler.GenerationSampler(jmodel, params, info)
    ts = tsampler.GenerationSampler(tmodel, info)
    seed, state, compared = 3, copy.deepcopy(md), 0
    for step, s in enumerate(schedule):
        jout = js.generate(copy.deepcopy(state), [s], seed=seed + step)
        tout = ts.generate(copy.deepcopy(state), [s], seed=seed + step)
        for key in ("input_mask", "target_mask"):  # the same positions were chosen
            np.testing.assert_array_equal(tout[t.target][key], jout[t.target][key])
        open_mask = ~state[t.target]["target_mask"]
        ids_keep = js._select_positions(~open_mask, s["num_tokens"],
                                        np.random.default_rng(seed + step), True)
        logits = _jax_step_logits(js, jmodel, params, state, t.target,
                                  s["cfg_cond_domains"], ids_keep)
        with inference_attention(), torch.no_grad():
            tdev = ts._to_device(state)
            ys = []
            for view, n in ((tdev, tsampler._bucket(ts._num_enc_tokens(state))),
                            ({m: ({**d, "input_mask": torch.ones_like(d["input_mask"])}
                                  if m in s["cfg_cond_domains"] else d)
                              for m, d in tdev.items()},
                             tsampler._bucket(ts._num_enc_tokens(
                                 state, exclude=tuple(s["cfg_cond_domains"])), 256))):
                ctx, mask = tmodel.forward_enc_context(view, n)
                ys.append(tmodel.forward_dec_subset_hidden(
                    view, t.target, ctx, mask, torch.from_numpy(ids_keep).long()))
            tlogits = tmodel.forward_mod_logits(t.target, ys[1] + 2.0 * (ys[0] - ys[1]))
        assert logits.shape == (2, L // t.steps, 256)
        np.testing.assert_allclose(tlogits.numpy(), logits, atol=LOGITS_ATOL, rtol=0)

        top2 = np.sort(logits, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > GAP
        rows = np.arange(ids_keep.shape[0])[:, None]
        tt = tout[t.target]["tensor"][rows, ids_keep]
        np.testing.assert_array_equal(tt[clear], logits.argmax(-1)[clear])
        compared += int(clear.sum())
        state = jout
    assert state[t.target]["target_mask"].all()
    assert compared >= 0.8 * 2 * L, f"only {compared} of {2 * L} tokens had a clear gap"


@pytest.mark.parametrize("task,steps", [("rgb2cam", 3), ("rgb2gaze", 5)])
def test_schedules_match_the_jax_entry_points(task, steps):
    """eval_model_rgb2{cam,gaze}.py: run_task(task, "tok_rgb", target, steps)
    builds this schedule (egom2p_tpu/cli/eval_common.py:180-187)."""
    t = eval_common.TASKS[task]
    assert (t.cond, t.steps, t.pattern, t.tokenizer) == ("tok_rgb", steps, f"{task}_*.npz",
                                                         t.target)
    ref = jsched.build_chained_generation_schedules(
        cond_domains=[t.cond], target_domains=[t.target], tokens_per_target=[30],
        autoregression_schemes=["roar"], decoding_steps=[steps],
        token_decoding_schedules=["linear"], temps=[0.01], temp_schedules=["constant"],
        cfg_scales=[2.0], cfg_schedules=["constant"], cfg_grow_conditioning=True)
    assert eval_common.roar_schedule(t.cond, t.target, t.steps) == ref
    assert sum(s["num_tokens"] for s in ref) == 30


def test_read_npz_tokens(tmp_path):
    grid = np.random.default_rng(0).integers(0, 64000, (5, 32, 32))
    np.savez(tmp_path / "rgb2cam_0.npz", grid)
    got = eval_common.read_npz_tokens(str(tmp_path / "rgb2cam_0.npz"), "tok_rgb")
    assert got.shape == (1, 5120) and got.dtype == np.int32
    np.testing.assert_array_equal(got[0], grid.reshape(-1))
    np.savez(tmp_path / "short.npz", grid[:2])
    with pytest.raises(ValueError, match="2048 tokens, tok_rgb takes 5120"):
        eval_common.read_npz_tokens(str(tmp_path / "short.npz"), "tok_rgb")


@pytest.fixture
def small_seq(monkeypatch):
    monkeypatch.setattr(eval_common, "SEQ_CONFIG", SMALL)


@pytest.mark.parametrize("task,key", [("rgb2cam", "tok_cam"), ("rgb2gaze", "tok_gaze")])
def test_load_task_loads_the_seq_tokenizer_and_no_cosmos(small_seq, monkeypatch, task, key):
    monkeypatch.setattr(eval_common, "load_video_tokenizer",
                        lambda *a: pytest.fail("rgb2cam / rgb2gaze load no Cosmos tokenizer"))
    args = eval_common.build_argparser(task).parse_args(
        ["--smoke", "--device", "cpu", "--model", TINY])
    sampler, tokenizers, schedule = eval_common.load_task(task, args)
    assert list(tokenizers) == [key]
    assert tokenizers[key].device.type == "cpu" and tokenizers[key].net.decoder.out_channels == \
        (9 if key == "tok_cam" else 2)
    assert len(schedule) == eval_common.TASKS[task].steps
    assert sampler.device.type == "cpu"


@pytest.mark.parametrize("entry", [eval_model_rgb2cam, eval_model_rgb2gaze],
                         ids=["rgb2cam", "rgb2gaze"])
def test_entry_point_runs_on_the_card_or_raises(tmp_path, entry):
    """--device defaults to cuda: with no CUDA device the entry point raises
    and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    np.savez(tmp_path / "rgb2cam_0.npz", np.zeros(5120, np.int64))
    np.savez(tmp_path / "rgb2gaze_0.npz", np.zeros(5120, np.int64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(["--smoke", "--model", TINY, "--data", str(tmp_path), "--out", str(tmp_path)])


@pytest.mark.parametrize("entry,flag,what", [
    (eval_model_rgb2cam, "--cam-tok-ckpt", "cam tokenizer"),
    (eval_model_rgb2gaze, "--gaze-tok-ckpt", "gaze tokenizer")], ids=["rgb2cam", "rgb2gaze"])
def test_missing_tokenizer_checkpoint_raises_without_smoke(tmp_path, entry, flag, what):
    """Every checkpoint the task reads is looked for before any is loaded:
    the main model's file exists here (and is never read)."""
    np.savez(tmp_path / "rgb2cam_0.npz", np.zeros(5120, np.int64))
    np.savez(tmp_path / "rgb2gaze_0.npz", np.zeros(5120, np.int64))
    (tmp_path / "main.pth").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match=f"{what} checkpoint .*none.pth not found"):
        entry.main(["--device", "cpu", "--data", str(tmp_path), "--out", str(tmp_path),
                    "--ckpt", str(tmp_path / "main.pth"), flag, str(tmp_path / "none.pth")])
    with pytest.raises(FileNotFoundError, match="EgoM2P checkpoint .*absent.pth not found"):
        entry.main(["--device", "cpu", "--data", str(tmp_path), "--out", str(tmp_path),
                    "--ckpt", str(tmp_path / "absent.pth"), flag, str(tmp_path / "none.pth")])
    with pytest.raises(FileNotFoundError, match="no inputs matching"):
        entry.main(["--smoke", "--device", "cpu", "--data", str(tmp_path / "empty"),
                    "--out", str(tmp_path)])


@pytest.mark.parametrize("domain,flag", [("cam", "--cam-tok-ckpt"), ("gaze", "--gaze-tok-ckpt")])
def test_load_seq_tokenizer_reads_the_checkpoint(small_seq, tmp_path, domain, flag):
    """Without --smoke the tokenizer is the .pth's, weights and codebook."""
    from egom2p_torch.core.checkpoint import save_seq_vqvae_pth
    from egom2p_torch.tokenizers.seq_vqvae import seq_vqvae_from_config

    tok = seq_vqvae_from_config(domain, torch.Generator().manual_seed(9), **SMALL)
    path = save_seq_vqvae_pth(tok, str(tmp_path / f"checkpoint-{domain}.pth"))
    args = eval_common.build_argparser(f"rgb2{domain}").parse_args(["--device", "cpu", flag, path])
    loaded = eval_common.load_seq_tokenizer(args, domain, "cpu")
    for k, v in tok.net.state_dict().items():
        torch.testing.assert_close(loaded.net.state_dict()[k], v, rtol=0, atol=0)
    smoke = eval_common.build_argparser(f"rgb2{domain}").parse_args(["--smoke", "--seed", "1"])
    a, b = (eval_common.load_seq_tokenizer(smoke, domain, "cpu") for _ in range(2))
    torch.testing.assert_close(a.vq_state.embed, b.vq_state.embed, rtol=0, atol=0)  # seeded
