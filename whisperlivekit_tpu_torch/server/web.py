"""Built-in web UI: mic capture → WS /asr → live transcript rendering.

Compact functional equivalent of the reference frontend (reference
web/live_transcription.{html,js,css} + web_interface.py): AudioWorklet PCM
capture (or MediaRecorder WebM/Opus when the server decodes via ffmpeg),
WS auto-reconnect with backoff, lines/speakers/silence/buffer/lag rendering.
Served inline as one HTML document.
"""

INDEX_HTML = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>WhisperLiveKit-TPU — live transcription</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
  :root { color-scheme: light dark; --fg:#1a1a1a; --bg:#fafafa; --muted:#777;
          --accent:#0a7cff; --line:#e4e4e4; --chip:#ececec; }
  @media (prefers-color-scheme: dark) {
    :root { --fg:#eee; --bg:#111; --muted:#999; --line:#2a2a2a; --chip:#222; } }
  html[data-theme="dark"]  { --fg:#eee; --bg:#111; --muted:#999; --line:#2a2a2a; --chip:#222; color-scheme:dark; }
  html[data-theme="light"] { --fg:#1a1a1a; --bg:#fafafa; --muted:#777; --line:#e4e4e4; --chip:#ececec; color-scheme:light; }
  body { font-family: system-ui, sans-serif; margin:0; background:var(--bg);
         color:var(--fg); display:flex; flex-direction:column; height:100vh; }
  header { display:flex; gap:1rem; align-items:center; padding:.8rem 1.2rem;
           border-bottom:1px solid var(--line); }
  h1 { font-size:1rem; margin:0; font-weight:600; }
  button { background:var(--accent); color:#fff; border:0; border-radius:2rem;
           padding:.55rem 1.4rem; font-size:.95rem; cursor:pointer; }
  button.recording { background:#e33; }
  #status { color:var(--muted); font-size:.85rem; }
  #chips { margin-left:auto; display:flex; gap:.4rem; align-items:center; }
  .chip { background:var(--chip); color:var(--muted); font-size:.72rem;
          border-radius:1rem; padding:.15rem .6rem; white-space:nowrap; }
  .chip.hot { color:#e33; }
  #theme { background:none; color:var(--muted); border:1px solid var(--line);
           border-radius:1rem; padding:.2rem .6rem; font-size:.75rem; cursor:pointer; }
  main { flex:1; overflow-y:auto; padding:1.2rem; max-width:56rem; width:100%;
         margin:0 auto; box-sizing:border-box; }
  .line { margin:.45rem 0; line-height:1.5; }
  .speaker { font-weight:600; color:var(--accent); margin-right:.5rem; }
  .silence { color:var(--muted); font-style:italic; font-size:.85rem; }
  .t { color:var(--muted); font-size:.75rem; margin-left:.5rem; }
  #buffer { color:var(--muted); }
  .translation { color:#3aa76d; font-size:.9rem; display:block; }
</style>
</head>
<body>
<header>
  <h1>WhisperLiveKit-TPU</h1>
  <button id="rec">Start</button>
  <span id="status">idle</span>
  <span id="chips">
    <span id="lag-proc" class="chip" hidden></span>
    <span id="lag-policy" class="chip" hidden></span>
    <span id="lag-diar" class="chip" hidden></span>
    <button id="theme" title="toggle theme">◐</button>
  </span>
</header>
<main><div id="lines"></div><div id="buffer"></div><div id="buffer2" class="silence"></div></main>
<script>
const btn = document.getElementById('rec');
const statusEl = document.getElementById('status');
const linesEl = document.getElementById('lines');
const bufferEl = document.getElementById('buffer');
const buffer2El = document.getElementById('buffer2');
const chipProc = document.getElementById('lag-proc');
const chipPolicy = document.getElementById('lag-policy');
const chipDiar = document.getElementById('lag-diar');

// lag-decomposition chips (reference lag chips: processing = audio received
// minus processed; policy = processed minus committed)
function chip(el, label, v, hotAt) {
  if (v > 0.3) { el.hidden = false; el.textContent = label + ' ' + v.toFixed(1) + 's';
                 el.classList.toggle('hot', v > hotAt); }
  else el.hidden = true;
}

const themeBtn = document.getElementById('theme');
themeBtn.onclick = () => {
  const cur = document.documentElement.dataset.theme ||
    (matchMedia('(prefers-color-scheme: dark)').matches ? 'dark' : 'light');
  const next = cur === 'dark' ? 'light' : 'dark';
  document.documentElement.dataset.theme = next;
  localStorage.setItem('wlk-theme', next);
};
const saved = localStorage.getItem('wlk-theme');
if (saved) document.documentElement.dataset.theme = saved;
let ws = null, ctx = null, node = null, stream = null, recording = false;
let recorder = null, useWorklet = true, retry = 0, configResolve = null;

const workletCode = `
class PCMForwarder extends AudioWorkletProcessor {
  process(inputs) {
    const ch = inputs[0][0];
    if (ch) this.port.postMessage(ch.slice(0));
    return true;
  }
}
registerProcessor('pcm-forwarder', PCMForwarder);`;

function wsUrl() {
  const proto = location.protocol === 'https:' ? 'wss:' : 'ws:';
  const params = new URLSearchParams(location.search);
  const qs = params.toString();
  return proto + '//' + location.host + '/asr' + (qs ? '?' + qs : '');
}

function render(data) {
  if (data.type === 'config') {
    useWorklet = !!data.useAudioWorklet;
    if (configResolve) { configResolve(); configResolve = null; }
    return;
  }
  if (data.type === 'ready_to_stop') { statusEl.textContent = 'finished'; return; }
  if (data.status === 'error') { statusEl.textContent = 'error: ' + (data.error||''); return; }
  const lines = data.lines || [];
  linesEl.innerHTML = lines.map(l => {
    if (l.speaker === -2) return '<div class="line silence">… silence (' + l.start + ' → ' + l.end + ')</div>';
    const spk = l.speaker > 0 ? '<span class="speaker">Speaker ' + l.speaker + '</span>' : '';
    const tr = l.translation ? '<span class="translation">' + l.translation + '</span>' : '';
    return '<div class="line">' + spk + (l.text||'') +
           '<span class="t">' + l.start + '–' + l.end + '</span>' + tr + '</div>';
  }).join('');
  bufferEl.textContent = data.buffer_transcription || '';
  buffer2El.textContent = data.buffer_diarization || data.buffer_translation || '';
  chip(chipProc, 'processing', data.remaining_time_transcription_processing || 0, 3);
  chip(chipPolicy, 'policy', data.remaining_time_transcription_policy || 0, 5);
  chip(chipDiar, 'diarization', data.remaining_time_diarization || 0, 5);
  window.scrollTo(0, document.body.scrollHeight);
}

function f32tos16(f32) {
  const out = new Int16Array(f32.length);
  for (let i = 0; i < f32.length; i++)
    out[i] = Math.max(-32768, Math.min(32767, f32[i] * 32768));
  return out.buffer;
}

async function start() {
  stream = await navigator.mediaDevices.getUserMedia({audio: {channelCount:1}});
  ws = new WebSocket(wsUrl());
  ws.binaryType = 'arraybuffer';
  ws.onmessage = e => render(JSON.parse(e.data));
  ws.onclose = () => { if (recording) setTimeout(() => { retry++; start(); },
                                                 Math.min(1000 * 2**retry, 15000)); };
  await new Promise(res => ws.onopen = res);
  retry = 0;
  // the server announces its expected format right after connect
  // (config.useAudioWorklet = pcm_input); fall back to the worklet default
  // if the message is late
  await new Promise(res => { configResolve = res; setTimeout(res, 1500); });

  if (useWorklet) {
    ctx = new AudioContext({sampleRate: 16000});
    const blob = new Blob([workletCode], {type:'application/javascript'});
    await ctx.audioWorklet.addModule(URL.createObjectURL(blob));
    const src = ctx.createMediaStreamSource(stream);
    node = new AudioWorkletNode(ctx, 'pcm-forwarder');
    node.port.onmessage = e => {
      if (ws && ws.readyState === 1) ws.send(f32tos16(e.data));
    };
    src.connect(node);
  } else {
    // server decodes container audio via ffmpeg: ship WebM/Opus chunks
    const mime = MediaRecorder.isTypeSupported('audio/webm;codecs=opus')
      ? 'audio/webm;codecs=opus' : 'audio/webm';
    recorder = new MediaRecorder(stream, {mimeType: mime});
    recorder.ondataavailable = e => {
      if (e.data.size && ws && ws.readyState === 1) ws.send(e.data);
    };
    recorder.start(250);
  }
  statusEl.textContent = 'recording';
}

async function stop() {
  if (recorder && recorder.state !== 'inactive') recorder.stop();
  recorder = null;
  if (node) node.disconnect();
  if (ctx) await ctx.close();
  if (stream) stream.getTracks().forEach(t => t.stop());
  if (ws && ws.readyState === 1) ws.send(new ArrayBuffer(0));
  statusEl.textContent = 'stopping…';
}

btn.onclick = async () => {
  recording = !recording;
  btn.textContent = recording ? 'Stop' : 'Start';
  btn.classList.toggle('recording', recording);
  if (recording) { try { await start(); } catch (e) { statusEl.textContent = 'mic error: ' + e; } }
  else await stop();
};
</script>
</body>
</html>
"""


def render_index() -> str:
    return INDEX_HTML
