"""Command line: text to a wav file (the port's counterpart of
``python -m tortoise_tts_tpu``, with the same arguments).

    python -m tortoise_tts_tpu_torch "text to speak" "ref1.wav;ref2.wav" \\
        --out-path out.wav [--yaml config.yaml] [--decode-quant w8a8] ...

It runs on the CUDA device, and raises where there is none, unless given
``--device cpu``.  ``--beam-width`` above 1 decodes by beam search (its
best beam chosen by ``--length-penalty``), ``--vocoder vocoder`` runs
UnivNet and ``--diffusion-sampler dpm++`` DPM-Solver++(2M).  Without
``--yaml``, ``TORTOISE_YAML``, ``TORTOISE_MODEL`` and ``TORTOISE_LORA``
configure it (``Config.from_cli``).
"""

import argparse
import dataclasses
import logging
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser("tortoise_tts_tpu_torch")
    parser.add_argument("text")
    parser.add_argument("references", type=str, nargs="?", default=None,
                        help="';'-separated reference wav paths")
    parser.add_argument("--out-path", type=Path, default=Path("out.wav"))
    parser.add_argument("--yaml", type=Path, default=None)
    parser.add_argument("--max-ar-steps", type=int, default=500)
    parser.add_argument("--max-diffusion-steps", type=int, default=80)
    parser.add_argument("--ar-temp", type=float, default=0.8)
    parser.add_argument("--diffusion-temp", type=float, default=1.0)
    parser.add_argument("--top-p", type=float, default=1.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--repetition-penalty", type=float, default=1.0)
    parser.add_argument("--length-penalty", type=float, default=1.0,
                        help="beam-selection length penalty (HF semantics)")
    parser.add_argument("--length-penalty-factor", type=float, default=0.0,
                        help="stop-logit length penalty for the sampled "
                             "path: stop /= length**factor (>0 = longer)")
    parser.add_argument("--beam-width", type=int, default=1)
    parser.add_argument("--diffusion-sampler", type=str, default="ddim",
                        choices=["ddim", "p", "dpm++"])
    parser.add_argument("--typical-sampling", action="store_true")
    parser.add_argument("--typical-mass", type=float, default=0.9)
    parser.add_argument("--mirostat-tau", type=float, default=0.0)
    parser.add_argument("--mirostat-eta", type=float, default=0.1)
    parser.add_argument("--min-temperature", type=float, default=0.0,
                        help="enable entropy-scaled dynamic temperature")
    parser.add_argument("--cond-free", action="store_true", default=True)
    parser.add_argument("--no-cond-free", dest="cond_free",
                        action="store_false")
    parser.add_argument("--vocoder", type=str, default="bigvgan",
                        choices=["bigvgan", "vocoder", "hifigan"])
    parser.add_argument("--candidates", type=int, default=1)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--dtype", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA device")
    parser.add_argument("--decode-quant", type=str, default=None,
                        choices=["none", "int8", "w8a8"],
                        help="AR-decode GEMV quantization "
                             "(config.Inference.decode_quant)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from .inference import TTS
    tts = TTS(config=args.yaml, dtype=args.dtype, device=args.device)
    if args.decode_quant is not None:
        tts.cfg = dataclasses.replace(tts.cfg, inference=dataclasses.replace(
            tts.cfg.inference, decode_quant=args.decode_quant))
    wav, sr = tts.inference(
        args.text, args.references,
        max_ar_steps=args.max_ar_steps,
        max_diffusion_steps=args.max_diffusion_steps,
        ar_temp=args.ar_temp, diffusion_temp=args.diffusion_temp,
        top_p=args.top_p, top_k=args.top_k,
        repetition_penalty=args.repetition_penalty,
        length_penalty=args.length_penalty,
        length_penalty_factor=args.length_penalty_factor,
        beam_width=args.beam_width,
        diffusion_sampler=args.diffusion_sampler, cond_free=args.cond_free,
        vocoder_type=args.vocoder, candidates=args.candidates,
        typical_sampling=args.typical_sampling,
        typical_mass=args.typical_mass,
        mirostat_tau=args.mirostat_tau, mirostat_eta=args.mirostat_eta,
        min_temperature=args.min_temperature,
        seed=args.seed, out_path=args.out_path)
    print(f"wrote {args.out_path} ({wav.shape[-1] / sr:.2f}s @ {sr}Hz)")


if __name__ == "__main__":
    main()
