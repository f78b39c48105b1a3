"""Self-contained single-page web UI (port of ``vtd_tpu/frontend/webapp.py``).

Page-parity with the reference's Streamlit frontend (reference
``app/frontend/main.py``): login/register, upload, my-videos,
processing (confidence slider + transformer toggle + 2 s status
polling), results (summary tiles, detected texts, detections table,
CSV download), analytics (category pie chart + upload timeline,
reference ``app/frontend/main.py:401-442``). Served by the API itself
at ``/app`` — no extra process, no Streamlit dependency.

CSP-compatible: the single <style> and <script> blocks carry a
per-request nonce (``render_index``), there are no inline event
handlers (everything binds via addEventListener), and every
user-controlled string rendered into the DOM goes through ``esc()``.
"""
from __future__ import annotations

INDEX_HTML_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Video Text Detection</title>
<style nonce="__NONCE__">
 body{font-family:system-ui,sans-serif;margin:0;background:#f5f6fa;color:#222}
 header{background:#1a237e;color:#fff;padding:12px 24px;display:flex;gap:24px;align-items:center}
 header h1{font-size:18px;margin:0}
 nav button{background:none;border:none;color:#c5cae9;font-size:14px;cursor:pointer;padding:6px 10px}
 nav button.active{color:#fff;border-bottom:2px solid #fff}
 main{max-width:960px;margin:24px auto;padding:0 16px}
 .card{background:#fff;border-radius:8px;padding:20px;margin-bottom:16px;box-shadow:0 1px 3px rgba(0,0,0,.1)}
 input,select{padding:8px;margin:4px 0;width:100%;box-sizing:border-box;border:1px solid #ccc;border-radius:4px}
 button.primary{background:#3949ab;color:#fff;border:none;padding:10px 18px;border-radius:4px;cursor:pointer}
 table{width:100%;border-collapse:collapse;font-size:13px}
 th,td{text-align:left;padding:6px 8px;border-bottom:1px solid #eee}
 .tiles{display:flex;gap:12px;flex-wrap:wrap}
 .tile{flex:1;min-width:140px;background:#e8eaf6;border-radius:8px;padding:14px;text-align:center}
 .tile b{display:block;font-size:22px}
 .bar{height:14px;background:#3949ab;border-radius:3px}
 .charts{display:flex;gap:24px;flex-wrap:wrap;align-items:flex-start}
 .legend{font-size:13px}
 .legend span{display:inline-block;width:12px;height:12px;border-radius:2px;margin-right:6px;vertical-align:middle}
 progress{width:100%}
 .err{color:#c62828}.ok{color:#2e7d32}
 .hidden{display:none}
</style></head><body>
<header><h1>Video Text Detection</h1>
<nav id="nav" class="hidden">
 <button data-page="upload">Upload</button>
 <button data-page="videos">My Videos</button>
 <button data-page="processing">Processing</button>
 <button data-page="results">Results</button>
 <button data-page="analytics">Analytics</button>
 <button id="logoutbtn">Logout</button>
</nav></header>
<main>
<div id="auth" class="card">
 <h2>Sign in</h2>
 <input id="username" placeholder="username">
 <input id="email" placeholder="email (register only)">
 <input id="password" type="password" placeholder="password">
 <p><button class="primary" id="loginbtn">Login</button>
    <button class="primary" id="registerbtn">Register</button></p>
 <p id="authmsg" class="err"></p>
</div>

<div id="page-upload" class="card hidden">
 <h2>Upload a video</h2>
 <p>Supported: mp4, avi, mov, mkv · max 500 MB · max 5 min</p>
 <input type="file" id="file">
 <select id="category"><option value="">category…</option>
  <option>activity</option><option>driving</option><option>game</option>
  <option>sports</option><option>street_indoor</option>
  <option>street_outdoor</option><option>other</option></select>
 <p><button class="primary" id="uploadbtn">Upload</button></p>
 <p id="upmsg"></p>
</div>

<div id="page-videos" class="card hidden"><h2>My videos</h2>
 <table id="vidtable"><thead><tr><th>ID</th><th>Name</th><th>Duration</th>
 <th>Size</th><th>Category</th><th></th></tr></thead><tbody></tbody></table>
</div>

<div id="page-processing" class="card hidden">
 <h2>Process a video</h2>
 <select id="procvid"></select>
 <label>Confidence threshold: <span id="confval">0.5</span>
  <input type="range" id="conf" min="0.1" max="0.9" step="0.05" value="0.5"></label>
 <label><input type="checkbox" id="usetr"> use transformer recognizer</label>
 <label><input type="checkbox" id="kfmode"> keyframe sampling (skip
  near-duplicate frames; detections propagate)</label>
 <label><input type="checkbox" id="tdedup"> temporal text dedup
  (cross-frame tracks)</label>
 <p><button class="primary" id="startbtn">Start detection</button></p>
 <div id="procstatus"></div>
</div>

<div id="page-results" class="card hidden">
 <h2>Results</h2>
 <select id="resvid"></select>
 <div id="restiles" class="tiles"></div>
 <div id="restexts"></div>
 <p><button id="csvbtn">Download CSV</button></p>
 <table id="restable"><thead><tr><th>Frame</th><th>Time</th><th>Text</th>
 <th>Det conf</th><th>Rec conf</th></tr></thead><tbody></tbody></table>
</div>

<div id="page-analytics" class="card hidden">
 <h2>Analytics</h2>
 <div class="charts"><div id="catpie"></div><div id="cats"></div></div>
 <div id="timeline"></div>
</div>
</main>
<script nonce="__NONCE__">
let token = localStorage.getItem('vtd_token') || null;
const api = (p) => '/api/v1' + p;
const hdrs = () => token ? {'Authorization':'Bearer '+token} : {};
// Escape user-controlled strings before any innerHTML interpolation.
const esc = (s) => String(s ?? '').replace(/[&<>"']/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
async function jfetch(p, opts={}) {
  opts.headers = Object.assign({}, opts.headers||{}, hdrs());
  const r = await fetch(p, opts);
  let body = null; try { body = await r.json(); } catch(e) {}
  return {status:r.status, body};
}
function show(page){
  document.querySelectorAll('main>.card').forEach(c=>c.classList.add('hidden'));
  document.getElementById(page==='auth'?'auth':'page-'+page).classList.remove('hidden');
  document.getElementById('nav').classList.toggle('hidden', page==='auth');
  document.querySelectorAll('#nav button[data-page]').forEach(b=>
    b.classList.toggle('active', b.dataset.page===page));
  if(page==='videos') loadVideos();
  if(page==='processing') fillSelect('procvid');
  if(page==='results') fillSelect('resvid').then(loadResults);
  if(page==='analytics') loadAnalytics();
}
async function login(){
  const fd = new URLSearchParams({username:username.value,password:password.value});
  const r = await fetch(api('/auth/login'),{method:'POST',
    headers:{'Content-Type':'application/x-www-form-urlencoded'},body:fd});
  if(r.ok){ token=(await r.json()).access_token;
    localStorage.setItem('vtd_token',token); show('upload'); }
  else authmsg.textContent='Login failed';
}
async function register(){
  const r = await fetch(api('/auth/register'),{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({email:email.value,username:username.value,password:password.value})});
  if(r.status===201){ token=(await r.json()).access_token;
    localStorage.setItem('vtd_token',token); show('upload'); }
  else authmsg.textContent='Registration failed: '+((await r.json()).detail||'');
}
function logout(){ token=null; localStorage.removeItem('vtd_token'); show('auth'); }
async function upload(){
  const f = file.files[0]; if(!f){upmsg.textContent='pick a file';return;}
  const fd = new FormData(); fd.append('file', f);
  if(category.value) fd.append('category', category.value);
  upmsg.textContent='uploading…';
  const r = await fetch(api('/videos/upload'),{method:'POST',headers:hdrs(),body:fd});
  upmsg.className = r.status===201?'ok':'err';
  upmsg.textContent = r.status===201?'Uploaded!':'Failed: '+((await r.json()).detail||r.status);
}
async function loadVideos(){
  const {body} = await jfetch(api('/videos/'));
  const tb = document.querySelector('#vidtable tbody'); tb.innerHTML='';
  (body||[]).forEach(v=>{
    tb.insertAdjacentHTML('beforeend', `<tr><td>${v.id}</td>
    <td>${esc(v.original_filename)}</td><td>${(v.duration||0).toFixed(1)}s</td>
    <td>${(v.file_size/1048576).toFixed(1)}MB</td><td>${esc(v.category||'')}</td>
    <td><button class="delbtn" data-id="${v.id}">delete</button></td></tr>`);});
  tb.querySelectorAll('.delbtn').forEach(b=>b.onclick=()=>delVideo(b.dataset.id));
}
async function delVideo(id){ await jfetch(api('/videos/'+id),{method:'DELETE'}); loadVideos(); }
async function fillSelect(id){
  const {body} = await jfetch(api('/videos/'));
  const s = document.getElementById(id); s.innerHTML='';
  (body||[]).forEach(v=>s.insertAdjacentHTML('beforeend',
    `<option value="${v.id}">#${v.id} ${esc(v.original_filename)}</option>`));
}
let pollTimer=null;
async function startProc(){
  const vid = procvid.value; if(!vid) return;
  const q = `?confidence_threshold=${conf.value}&use_transformer=${usetr.checked}`
    + `&sample_mode=${kfmode.checked?'keyframe':'stride'}`
    + `&temporal_dedup=${tdedup.checked}`;
  const {status, body} = await jfetch(api(`/processing/videos/${vid}/detect`+q),{method:'POST'});
  if(status!==200){procstatus.innerHTML=`<p class="err">${esc(body.detail||status)}</p>`;return;}
  const job = body; procstatus.innerHTML='<progress max="100" value="0"></progress><span id="pct"></span>';
  clearInterval(pollTimer);
  pollTimer = setInterval(async ()=>{               // 2 s polling, like the reference UI
    const {body:s} = await jfetch(api(`/processing/jobs/${job.id}/status`));
    if(!s) return;
    document.querySelector('#procstatus progress').value = s.progress||0;
    document.getElementById('pct').textContent =
      ` ${s.status} ${(s.progress||0).toFixed(0)}% (${s.processed_frames||0}/${s.total_frames||'?'})`;
    if(['completed','failed','cancelled'].includes(s.status)){
      clearInterval(pollTimer);
      procstatus.insertAdjacentHTML('beforeend',
        `<p class="${s.status==='completed'?'ok':'err'}">${esc(s.status)}${s.error_message?': '+esc(s.error_message):''}</p>`);
    }
  },2000);
}
let lastResults=null;
async function loadResults(){
  const vid = resvid.value; if(!vid) return;
  const {status, body} = await jfetch(api(`/processing/videos/${vid}/results`));
  if(status!==200){restiles.innerHTML='<p>No completed results.</p>';
    restexts.innerHTML=''; document.querySelector('#restable tbody').innerHTML=''; return;}
  lastResults = body.results;
  const s = body.summary||{};
  restiles.innerHTML = ['total_frames','frames_with_text','total_detections','unique_texts']
    .map(k=>`<div class="tile"><b>${s[k]??0}</b>${k.replaceAll('_',' ')}</div>`).join('');
  restexts.innerHTML = '<h3>Detected text</h3>'+
    (s.detected_texts||[]).map(t=>`<code>${esc(t)}</code>`).join(' ');
  const tb = document.querySelector('#restable tbody'); tb.innerHTML='';
  (body.results.results||[]).slice(0,500).forEach(fr=>fr.detections.forEach(d=>
    tb.insertAdjacentHTML('beforeend',`<tr><td>${fr.frame_number}</td>
    <td>${fr.timestamp.toFixed(2)}</td><td>${esc(d.text)}</td>
    <td>${d.detection_confidence.toFixed(2)}</td>
    <td>${d.recognition_confidence.toFixed(2)}</td></tr>`)));
}
async function downloadCSV(){
  const vid = resvid.value; if(!vid) return;
  const {status, body} = await jfetch(api(`/processing/videos/${vid}/results?format=csv`));
  if(status !== 200 || !body || body.content === undefined){
    alert('CSV export failed: ' + ((body&&body.detail) || ('HTTP '+status)));
    return;
  }
  const blob = new Blob([body.content],{type:'text/csv'});
  const a = document.createElement('a');
  a.href = URL.createObjectURL(blob); a.download=`video_${vid}_results.csv`; a.click();
}
const PIE_COLORS=['#3949ab','#e53935','#43a047','#fb8c00','#8e24aa','#00acc1','#6d4c41'];
function pieSVG(counts){
  // Category pie chart (reference analytics: plotly px.pie, main.py:401-420).
  const entries=Object.entries(counts); const total=entries.reduce((a,[,n])=>a+n,0)||1;
  let a0=-Math.PI/2, paths='';
  entries.forEach(([k,n],i)=>{
    const a1=a0+2*Math.PI*n/total;
    const large=(a1-a0)>Math.PI?1:0;
    const x0=100+90*Math.cos(a0),y0=100+90*Math.sin(a0);
    const x1=100+90*Math.cos(a1),y1=100+90*Math.sin(a1);
    paths += entries.length===1
      ? `<circle cx="100" cy="100" r="90" fill="${PIE_COLORS[i%7]}"/>`
      : `<path d="M100,100 L${x0.toFixed(1)},${y0.toFixed(1)} A90,90 0 ${large} 1 ${x1.toFixed(1)},${y1.toFixed(1)} Z" fill="${PIE_COLORS[i%7]}"/>`;
    a0=a1;});
  return `<svg width="200" height="200" viewBox="0 0 200 200" role="img">${paths}</svg>`;
}
function timelineSVG(days){
  // Upload timeline (reference: px.histogram over upload dates, main.py:422-442).
  const keys=Object.keys(days).sort(); if(!keys.length) return '';
  const max=Math.max(...keys.map(k=>days[k]));
  const w=Math.max(480,keys.length*28), bw=Math.max(8,Math.floor(w/keys.length)-6);
  let bars='';
  keys.forEach((k,i)=>{
    const h=Math.round(120*days[k]/max);
    bars+=`<rect x="${i*(bw+6)+4}" y="${130-h}" width="${bw}" height="${h}" fill="#3949ab"><title>${esc(k)}: ${days[k]}</title></rect>`
        +`<text x="${i*(bw+6)+4+bw/2}" y="145" font-size="9" text-anchor="middle">${esc(k.slice(5))}</text>`;});
  return `<h3>Upload timeline</h3><svg width="${w}" height="150">${bars}</svg>`;
}
async function loadAnalytics(){
  const {body} = await jfetch(api('/videos/'));
  const counts={}, days={};
  (body||[]).forEach(v=>{
    const c=v.category||'uncategorized'; counts[c]=(counts[c]||0)+1;
    if(v.created_at){const d=String(v.created_at).slice(0,10); days[d]=(days[d]||0)+1;}});
  catpie.innerHTML = pieSVG(counts);
  const max = Math.max(1,...Object.values(counts));
  cats.innerHTML = '<h3>Uploads by category</h3>'+Object.entries(counts).map(([k,n],i)=>
    `<div class="legend" style="margin:6px 0"><span style="background:${PIE_COLORS[i%7]}"></span>${esc(k)} (${n})`+
    `<div class="bar" style="width:${n/max*100}%"></div></div>`).join('');
  timeline.innerHTML = timelineSVG(days);
}
document.getElementById('loginbtn').addEventListener('click', login);
document.getElementById('registerbtn').addEventListener('click', register);
document.getElementById('logoutbtn').addEventListener('click', logout);
document.getElementById('uploadbtn').addEventListener('click', upload);
document.getElementById('startbtn').addEventListener('click', startProc);
document.getElementById('csvbtn').addEventListener('click', downloadCSV);
document.getElementById('resvid').addEventListener('change', loadResults);
document.getElementById('conf').addEventListener('input',
  e=>document.getElementById('confval').textContent=e.target.value);
document.querySelectorAll('#nav button[data-page]').forEach(b=>
  b.addEventListener('click', ()=>show(b.dataset.page)));
if(token) show('upload'); else show('auth');
</script></body></html>
"""


def render_index(nonce: str) -> str:
    """Render the SPA with a per-request CSP nonce on its style/script."""
    return INDEX_HTML_TEMPLATE.replace("__NONCE__", nonce)


# Backwards-compatible plain render (no nonce attributes honored by CSP;
# used only where no CSP header is applied).
INDEX_HTML = render_index("")
