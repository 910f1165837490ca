"""Web UI (port of ``tortoise_tts_tpu/webui.py``; reference webui.py).

    python -m tortoise_tts_tpu_torch.webui [--listen 0.0.0.0:7860] \
        [--yaml config.yaml] [--device cpu]

Serves the port's ``TTS`` (on the CUDA device unless ``--device`` says
otherwise).  Uses gradio when installed, as the reference does;
otherwise a dependency-free stdlib HTTP UI with the same inference knobs
(text, reference audio paths, AR and diffusion steps, temperatures,
top-p/k, penalties, sampler, vocoder, seed) and a random
Harvard-sentence prompt (webui.py:166-199):

- ``GET /``: the form; ``POST /generate``: one ``TTS.inference`` call,
  its wav written under the audio directory and linked as
  ``/audio/<name>``; a generation error is shown in the page;
- ``GET /stream?text=...&references=...``: chunked 16-bit WAV from
  ``TTS.stream`` as the decode advances (an error is logged and closes
  the connection, so the response ends without its closing chunk).

The generated wavs go to ``<temporary directory>/tortoise_tts_tpu_torch_
webui`` (``tempfile.gettempdir()``, so ``TMPDIR`` moves it) unless
``make_server`` is given ``out_dir``.
"""

from __future__ import annotations

import argparse
import html
import logging
import random
import struct
import tempfile
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

_logger = logging.getLogger(__name__)

# short Harvard-sentences subset (reference data.py:197-273 random prompts)
HARVARD_SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.",
    "The hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.",
    "A large size in stockings is hard to sell.",
]


def random_prompt() -> str:
    return random.choice(HARVARD_SENTENCES)


_FORM = """<!doctype html><html><head><title>tortoise-tts-tpu</title>
<style>body{{font-family:sans-serif;max-width:720px;margin:2em auto}}
label{{display:block;margin-top:.6em}}input,select,textarea{{width:100%}}
.row{{display:flex;gap:1em}}.row>div{{flex:1}}</style></head><body>
<h2>tortoise-tts-tpu</h2>
<form method="post" action="/generate">
<label>Text <textarea name="text" rows="3">{text}</textarea></label>
<label>Reference wav path(s, ';'-separated)
 <input name="references" value="{references}"></label>
<div class="row">
<div><label>AR steps <input name="max_ar_steps" value="500"></label></div>
<div><label>Diffusion steps <input name="max_diffusion_steps" value="80"></label></div>
<div><label>AR temp <input name="ar_temp" value="0.8"></label></div>
<div><label>Diff temp <input name="diffusion_temp" value="1.0"></label></div>
</div>
<div class="row">
<div><label>top_p <input name="top_p" value="1.0"></label></div>
<div><label>top_k <input name="top_k" value="0"></label></div>
<div><label>rep penalty <input name="repetition_penalty" value="1.0"></label></div>
<div><label>seed <input name="seed" value=""></label></div>
</div>
<div class="row">
<div><label>beam width <input name="beam_width" value="1"></label></div>
<div><label>length penalty <input name="length_penalty" value="1.0"></label></div>
<div><label>length factor <input name="length_penalty_factor" value="0.0"></label></div>
<div><label>candidates <input name="candidates" value="1"></label></div>
<div><label>typical <select name="typical_sampling">
<option>false</option><option>true</option></select></label></div>
</div>
<div class="row">
<div><label>Sampler <select name="diffusion_sampler">
<option>ddim</option><option>p</option><option>dpm++</option></select></label></div>
<div><label>Vocoder <select name="vocoder_type">
<option>bigvgan</option><option>vocoder</option><option>hifigan</option>
</select></label></div>
<div><label>cond_free <select name="cond_free">
<option>true</option><option>false</option></select></label></div>
</div>
<p><button type="submit">Generate</button>
<a href="/?prompt=random">random prompt</a></p>
</form>{result}</body></html>"""


def wav_stream_header(sr: int = 24_000) -> bytes:
    """A 16-bit mono WAV header of unknown length (the sizes at their
    maximum), for a stream."""
    maxlen = 0xFFFFFFFF
    return (b"RIFF" + struct.pack("<I", maxlen) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
            + b"data" + struct.pack("<I", maxlen))


def _make_handler(tts, out_dir: Path | None = None):
    out_dir = Path(out_dir) if out_dir is not None else \
        Path(tempfile.gettempdir()) / "tortoise_tts_tpu_torch_webui"

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer encoding is HTTP/1.1-only; the BaseHTTPRequest
        # default (HTTP/1.0) would make clients read the chunk framing as
        # audio bytes
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            _logger.info(fmt, *args)

        def _page(self, text="", references="", result=""):
            body = _FORM.format(text=html.escape(text or random_prompt()),
                                references=html.escape(references),
                                result=result)
            payload = body.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _stream(self):
            # chunked streaming audio out of the UI (reference webui.py:237
            # gradio streaming=True): the HiFiGAN route, a WAV header of
            # unknown length, then PCM chunks as the decode advances
            q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
            text = q.get("text", [random_prompt()])[0]
            refs = q.get("references", [None])[0]
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data + b"\r\n")

            try:
                chunk(wav_stream_header())
                for wav in tts.stream(text, refs):
                    pcm = np.clip(np.asarray(wav), -1, 1)
                    chunk((pcm * 32767).astype("<i2").tobytes())
                chunk(b"")
            except Exception:
                _logger.exception("streaming failed")
                # no closing chunk follows: drop the connection, so the
                # client sees a cut response instead of waiting on it
                self.close_connection = True

        def do_GET(self):
            if self.path.startswith("/stream"):
                self._stream()
                return
            if self.path.startswith("/audio/"):
                p = out_dir / Path(self.path).name
                if p.exists():
                    payload = p.read_bytes()
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                self.send_error(404)
                return
            self._page()

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            data = urllib.parse.parse_qs(self.rfile.read(length).decode())

            def get(k, default=None, cast=str):
                v = data.get(k, [None])[0]
                return default if v in (None, "") else cast(v)

            text = get("text", random_prompt())
            refs = get("references")
            out_dir.mkdir(parents=True, exist_ok=True)
            name = f"{random.randrange(1 << 30):08x}.wav"
            try:
                tts.inference(
                    text, refs,
                    max_ar_steps=get("max_ar_steps", 500, int),
                    max_diffusion_steps=get("max_diffusion_steps", 80, int),
                    ar_temp=get("ar_temp", 0.8, float),
                    diffusion_temp=get("diffusion_temp", 1.0, float),
                    top_p=get("top_p", 1.0, float),
                    top_k=get("top_k", 0, int),
                    repetition_penalty=get("repetition_penalty", 1.0, float),
                    beam_width=get("beam_width", 1, int),
                    length_penalty=get("length_penalty", 1.0, float),
                    length_penalty_factor=get("length_penalty_factor",
                                              0.0, float),
                    candidates=get("candidates", 1, int),
                    typical_sampling=get("typical_sampling",
                                         "false") == "true",
                    diffusion_sampler=get("diffusion_sampler", "ddim"),
                    cond_free=get("cond_free", "true") == "true",
                    vocoder_type=get("vocoder_type", "bigvgan"),
                    seed=get("seed", None, int),
                    out_path=out_dir / name)
                result = (f'<h3>Result</h3><audio controls '
                          f'src="/audio/{name}"></audio>')
            except Exception as e:  # shown in the UI
                _logger.exception("generation failed")
                result = f"<pre>error: {html.escape(str(e))}</pre>"
            self._page(text=text, references=refs or "", result=result)

    return Handler


def make_server(tts, host: str = "127.0.0.1", port: int = 7860,
                out_dir: Path | None = None) -> ThreadingHTTPServer:
    """The stdlib server over ``tts`` (port 0: a free port), not started."""
    return ThreadingHTTPServer((host, port), _make_handler(tts, out_dir))


def start(host: str = "127.0.0.1", port: int = 7860, config=None,
          device=None):
    """Serve a new ``TTS(config, device=device)``: gradio when installed,
    else the stdlib server, until interrupted."""
    from .inference import TTS
    tts = TTS(config=config, device=device)
    try:
        import gradio  # noqa: F401
        return _start_gradio(tts, host, port)
    except ImportError:
        pass
    server = make_server(tts, host, port)
    _logger.info("webui listening on http://%s:%d", host,
                 server.server_port)
    server.serve_forever()


def _start_gradio(tts, host, port):
    import gradio as gr

    def generate(text, references, ar_steps, diff_steps, ar_temp, top_p,
                 vocoder, seed):
        wav, sr = tts.inference(
            text, references or None, max_ar_steps=int(ar_steps),
            max_diffusion_steps=int(diff_steps), ar_temp=float(ar_temp),
            top_p=float(top_p), vocoder_type=vocoder,
            seed=int(seed) if seed else None)
        return sr, wav

    demo = gr.Interface(
        fn=generate,
        inputs=[gr.Textbox(label="Text", value=random_prompt()),
                gr.Textbox(label="Reference wavs (';'-separated)"),
                gr.Number(value=500, label="AR steps"),
                gr.Number(value=80, label="Diffusion steps"),
                gr.Number(value=0.8, label="AR temperature"),
                gr.Number(value=1.0, label="top_p"),
                gr.Dropdown(["bigvgan", "vocoder", "hifigan"],
                            value="bigvgan", label="Vocoder"),
                gr.Textbox(label="Seed")],
        outputs=gr.Audio(label="Output"))
    demo.launch(server_name=host, server_port=port)


def main(argv=None):
    parser = argparse.ArgumentParser("tortoise_tts_tpu_torch.webui")
    parser.add_argument("--listen", type=str, default="127.0.0.1:7860")
    parser.add_argument("--yaml", type=Path, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    host, _, port = args.listen.partition(":")
    start(host or "127.0.0.1", int(port or 7860), config=args.yaml,
          device=args.device)


if __name__ == "__main__":
    main()
