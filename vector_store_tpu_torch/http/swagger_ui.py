"""Interactive API documentation page at /swagger-ui (reference serves
utoipa-swagger-ui there, httproutes.rs:160-166).

This environment is zero-egress and the full swagger-ui dist is ~4 MB of
vendored assets, so the page is a small self-contained renderer of the
service's own /api-docs/openapi.json: it lists every path/method with its
parameters, request/response schemas, and a try-it-out form that POSTs
from the browser — the workflows people actually use swagger-ui for.
"""

from __future__ import annotations

PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8"/>
<title>Vector Store API</title>
<style>
  :root { --bg:#fafafa; --fg:#1a1a2e; --mut:#667; --line:#e0e0e8; --get:#2f6f4f; --post:#1f5f8f; --del:#a33; --put:#96610f; }
  body { font-family: -apple-system, "Segoe UI", Roboto, sans-serif; margin:0; background:var(--bg); color:var(--fg); }
  header { padding:20px 32px; border-bottom:1px solid var(--line); background:#fff; }
  header h1 { margin:0; font-size:20px; }
  header .v { color:var(--mut); font-size:13px; }
  main { max-width:960px; margin:0 auto; padding:24px 32px; }
  .op { background:#fff; border:1px solid var(--line); border-radius:8px; margin:12px 0; overflow:hidden; }
  .op > summary { padding:10px 16px; cursor:pointer; display:flex; gap:12px; align-items:center; list-style:none; }
  .op > summary::-webkit-details-marker { display:none; }
  .m { font-weight:700; font-size:12px; padding:3px 10px; border-radius:4px; color:#fff; min-width:46px; text-align:center; }
  .m.get{background:var(--get)} .m.post{background:var(--post)} .m.delete{background:var(--del)} .m.put{background:var(--put)}
  .p { font-family: ui-monospace, monospace; font-size:14px; }
  .s { color:var(--mut); font-size:13px; margin-left:auto; }
  .body { padding:4px 16px 16px; border-top:1px solid var(--line); font-size:13px; }
  .body h4 { margin:12px 0 4px; font-size:12px; text-transform:uppercase; color:var(--mut); }
  pre { background:#f4f4f8; border:1px solid var(--line); border-radius:6px; padding:10px; overflow:auto; font-size:12px; }
  textarea { width:100%; min-height:90px; font-family:ui-monospace,monospace; font-size:12px; border:1px solid var(--line); border-radius:6px; padding:8px; box-sizing:border-box; }
  input[type=text] { font-family:ui-monospace,monospace; font-size:12px; border:1px solid var(--line); border-radius:6px; padding:5px 8px; margin:2px 6px 2px 0; }
  button { background:var(--fg); color:#fff; border:0; border-radius:6px; padding:7px 16px; font-size:13px; cursor:pointer; margin-top:8px; }
  .resp { margin-top:10px; }
  table { border-collapse:collapse; }
  td, th { border:1px solid var(--line); padding:4px 10px; font-size:12px; text-align:left; }
</style>
</head>
<body>
<header><h1 id="title">Vector Store API</h1><div class="v" id="version"></div></header>
<main id="ops">loading /api-docs/openapi.json…</main>
<script>
async function main() {
  const doc = await (await fetch('/api-docs/openapi.json')).json();
  document.getElementById('title').textContent = (doc.info && doc.info.title) || 'API';
  document.getElementById('version').textContent =
    ((doc.info && doc.info.version) ? 'version ' + doc.info.version : '') + ' — OpenAPI ' + (doc.openapi || '');
  const root = document.getElementById('ops');
  root.textContent = '';
  const schemas = (doc.components && doc.components.schemas) || {};
  const deref = s => (s && s.$ref) ? schemas[s.$ref.split('/').pop()] || s : s;
  function example(s, depth) {
    s = deref(s); depth = depth || 0;
    if (!s || depth > 4) return null;
    if (s.example !== undefined) return s.example;
    if (s.enum) return s.enum[0];
    if (s.type === 'object' || s.properties) {
      const o = {};
      for (const [k, v] of Object.entries(s.properties || {})) o[k] = example(v, depth+1);
      return o;
    }
    if (s.type === 'array') return [example(s.items, depth+1)];
    if (s.type === 'string') return 'string';
    if (s.type === 'integer') return 1;
    if (s.type === 'number') return 0.5;
    if (s.type === 'boolean') return true;
    return null;
  }
  for (const [path, methods] of Object.entries(doc.paths || {})) {
    for (const [method, op] of Object.entries(methods)) {
      const d = document.createElement('details'); d.className = 'op';
      const sum = document.createElement('summary');
      sum.innerHTML = '<span class="m ' + method + '">' + method.toUpperCase() +
        '</span><span class="p">' + path + '</span><span class="s">' + (op.summary || '') + '</span>';
      d.appendChild(sum);
      const body = document.createElement('div'); body.className = 'body';
      const params = (op.parameters || []).filter(p => p.in === 'path');
      let html = '';
      if (op.description) html += '<p>' + op.description + '</p>';
      if (params.length) {
        html += '<h4>Path parameters</h4><div class="params">' +
          params.map(p => '<label>' + p.name + ' <input type="text" data-param="' + p.name + '"/></label>').join(' ') + '</div>';
      }
      const reqSchema = op.requestBody && op.requestBody.content &&
        op.requestBody.content['application/json'] && op.requestBody.content['application/json'].schema;
      if (reqSchema) {
        html += '<h4>Request body</h4><textarea data-body>' +
          JSON.stringify(example(reqSchema), null, 2) + '</textarea>';
      }
      html += '<h4>Responses</h4><table><tr><th>code</th><th>description</th></tr>' +
        Object.entries(op.responses || {}).map(([c, r]) =>
          '<tr><td>' + c + '</td><td>' + (r.description || '') + '</td></tr>').join('') + '</table>';
      html += '<button data-try>Try it out</button><div class="resp"></div>';
      body.innerHTML = html;
      body.querySelector('[data-try]').onclick = async () => {
        let url = path;
        for (const inp of body.querySelectorAll('[data-param]'))
          url = url.replace('{' + inp.dataset.param + '}', encodeURIComponent(inp.value));
        const opts = { method: method.toUpperCase() };
        const ta = body.querySelector('[data-body]');
        if (ta) { opts.headers = {'Content-Type': 'application/json'}; opts.body = ta.value; }
        const respEl = body.querySelector('.resp');
        try {
          const r = await fetch(url, opts);
          const text = await r.text();
          let shown = text;
          try { shown = JSON.stringify(JSON.parse(text), null, 2); } catch (e) {}
          respEl.innerHTML = '<h4>HTTP ' + r.status + '</h4><pre></pre>';
          respEl.querySelector('pre').textContent = shown;
        } catch (e) {
          respEl.innerHTML = '<h4>request failed</h4><pre></pre>';
          respEl.querySelector('pre').textContent = String(e);
        }
      };
      d.appendChild(body);
      root.appendChild(d);
    }
  }
}
main();
</script>
</body>
</html>
"""
